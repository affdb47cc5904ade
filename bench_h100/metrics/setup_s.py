"""Seconds from the process's start to the first timed request: imports,
traffic generation, weights, the interface, kernel builds, CUDA graph
captures and the warm-up."""


def read(run):
    return run.setup_s
