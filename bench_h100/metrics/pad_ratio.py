"""Mel frames the vocoder ran (the frames of each step the program ran,
times its rows, as ``serve.record_shapes`` read them from the outputs it
handed back) over the mel frames delivered, summed over the window."""


def read(run):
    delivered = sum(r["frames"] for r in run.served)
    ran = sum(r["vocoder_frames"] * r["rows"] for r in run.served)
    return ran / delivered if delivered else None
