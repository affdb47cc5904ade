"""Small audio I/O helpers (``Utility/utils.py:20`` float2pcm etc.): a copy
of ``toucan_tpu/utils/audio_io.py``."""

import numpy as np


def float2pcm(sig, dtype="int16"):
    """Float [-1, 1] -> integer PCM, reference semantics."""
    sig = np.asarray(sig)
    if sig.dtype.kind != "f":
        raise TypeError("'sig' must be a float array")
    dtype = np.dtype(dtype)
    if dtype.kind not in "iu":
        raise TypeError("'dtype' must be an integer type")
    i = np.iinfo(dtype)
    abs_max = 2 ** (i.bits - 1)
    offset = i.min + abs_max
    return (sig * abs_max + offset).clip(i.min, i.max).astype(dtype)


def cumsum_durations(durations):
    """Duration splits + label midpoints for plotting
    (``Utility/utils.py:291``)."""
    splits = np.concatenate([[0], np.cumsum(durations)])
    label_positions = (splits[1:] + splits[:-1]) / 2
    return splits[1:], label_positions
