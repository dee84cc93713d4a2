"""hybrid_span_ms.<cell>: device ms a frame in the program's spans
"tpv#hybrid" (every encoder layer's cross-view hybrid attention), summed,
over the number of spans "tpv#frame".

The stream's wall time between each span's CUDA event pair in the
profiled phase of a traced run: idle stretches included, not the
device's busy time."""

from verbench.program_spans import device_ms


def read(run):
    return device_ms("tpv#hybrid", per="tpv#frame")
