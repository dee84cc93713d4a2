"""lift_ms.dump: device ms per occurrence of the benchmark's span "lift"
(CUDA events from its hooks, traced run)."""

from verbench.readers import span


def read(run):
    return span(run, "lift")
