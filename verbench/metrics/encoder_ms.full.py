"""encoder_ms.full: device ms per occurrence of the benchmark's span "encoder"
(CUDA events from its hooks, traced run)."""

from verbench.readers import span


def read(run):
    return span(run, "encoder")
