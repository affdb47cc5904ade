"""Rel-pos flash attention (K1, ``csrc/flash_rel_attention.cu``, f32): its least time at
the shapes of every launch in the traced window (roofline/launches.py,
roofline/kernels.py) over its summed device time in the profiler.
Silent where the trace's launches are not the ones the path should make."""

from bench_h100.roofline import kernels, launches, peaks

PATTERN = r"(?<![A-Za-z0-9_])flash_rel_kernel(?![A-Za-z0-9_])"


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernel_times(PATTERN)
    shapes = [s for r in run.served for s in launches.k1(run.config, r)]
    if not times or len(times) != len(shapes):
        return None
    least = sum(peaks.bound_s(*kernels.k1(*s), kernels.K1_PEAK) for s in shapes)
    return 100.0 * least / sum(times)
