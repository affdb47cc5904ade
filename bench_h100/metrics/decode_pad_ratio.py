"""Mel frames the acoustic model decoded (the frames of each step the
program ran, times its rows, as the family's ``record_shapes`` read them
from the outputs it handed back) over the mel frames delivered, summed
over the window."""


def read(run):
    delivered = sum(r["frames"] for r in run.served)
    decoded = sum(r["decoder_frames"] * r["rows"] for r in run.served)
    return decoded / delivered if delivered else None
