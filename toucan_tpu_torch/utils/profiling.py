"""Tracing and step timing.

Counterpart of ``toucan_tpu/utils/profiling.py``: ``profile_trace`` wraps
a block in ``torch.profiler`` (the JAX package's wraps ``jax.profiler``)
and writes a Chrome trace into ``logdir``; ``StepTimer`` is a copy.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` around a block, with CPU activity and, where a
    card is visible, CUDA activity; the trace is written to
    ``logdir/trace.json`` (open it in Perfetto or ``chrome://tracing``).
    Yields the profiler, whose ``key_averages()`` the caller may read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Rolling per-step wall-clock timing with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._count = 0
        self._total = 0.0
        self._last = None

    def __enter__(self):
        self._last = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._last
        self._count += 1
        if self._count > self.warmup:
            self._total += dt

    @property
    def mean_step_seconds(self):
        steps = max(self._count - self.warmup, 1)
        return self._total / steps
