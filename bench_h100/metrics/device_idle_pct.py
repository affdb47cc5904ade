"""Share of the traced window in which no kernel, copy or set ran on the
device (the union of the profiler's device intervals)."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
