"""Mean host milliseconds of the interface's ``string_to_features`` a
sentence, from the benchmark's wrapper in the traced run."""


def read(run):
    times = run.frontend_s
    return 1e3 * sum(times) / len(times) if times else None
