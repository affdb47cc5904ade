"""95th percentile of the host-clock time from a request's send to its
wave on the host, over every request of the window (a failed request
counts as the slowest)."""

from bench_h100.harness.run import percentile_ms


def read(run):
    return percentile_ms(run, 95)
