"""Seconds of speech delivered per second of the window: each served
sentence's mel frames x 384 samples at 24 kHz (no silence joins), over the
window from its start to the end of its last request."""

from bench_h100.harness.serve import SAMPLE_RATE, SAMPLES_PER_FRAME


def read(run):
    frames = sum(r["frames"] for r in run.served)
    return frames * SAMPLES_PER_FRAME / SAMPLE_RATE / run.window_s if run.served else None
