"""Device-idle ms a ``toucan.call`` whose innermost program span is the
sentence's dispatch, its staging (host padding, copies to the device), a
bucket's replay or a capture (``harness/program_spans.py``)."""

from bench_h100.harness import program_spans


def read(run):
    return program_spans.idle_ms_per(run.trace, program_spans.DISPATCH, "toucan.call")
