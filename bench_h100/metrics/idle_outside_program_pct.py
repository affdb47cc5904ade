"""Share of the traced window with the device idle and no ``toucan.`` span
of the program open on the host: the client, the harness and the profiler
(``harness/program_spans.py``)."""

from bench_h100.harness import program_spans


def read(run):
    idle = program_spans.idle_ns(run.trace)
    if idle is None:
        return None
    return 100.0 * idle.get(program_spans.OUTSIDE, 0) / 1e9 / run.trace.window_s
