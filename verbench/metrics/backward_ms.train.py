"""backward_ms.train: device ms per occurrence of the benchmark's span "backward"
(CUDA events from its hooks, traced run)."""

from verbench.readers import span


def read(run):
    return span(run, "backward")
