"""Device-idle ms a ``toucan.read_to_file`` page under ``toucan.write``: the
join with silence, the int16 conversion and the WAV write
(``harness/program_spans.py``)."""

from bench_h100.harness import program_spans


def read(run):
    return program_spans.idle_ms_per(run.trace, ("toucan.write",), "toucan.read_to_file")
