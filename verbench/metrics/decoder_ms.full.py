"""decoder_ms.full: device ms per occurrence of the benchmark's span "decoder"
(CUDA events from its hooks, traced run)."""

from verbench.readers import span


def read(run):
    return span(run, "decoder")
