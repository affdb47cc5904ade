"""The general part of the benchmark: it reads a cell of ``BENCHMARK.json``
and runs it.  What belongs to one configuration, traffic mix or metric
lives in ``configs/``, ``traffic/`` and ``metrics/`` and is found by name."""
