"""Device-idle ms a ``toucan.call`` under ``toucan.fetch``: the reads of the
device's outputs to the host and their waits (``harness/program_spans.py``)."""

from bench_h100.harness import program_spans


def read(run):
    return program_spans.idle_ms_per(run.trace, ("toucan.fetch",), "toucan.call")
