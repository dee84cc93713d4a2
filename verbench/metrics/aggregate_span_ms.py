"""aggregate_span_ms.<cell>: device ms a frame in the program's spans
"tpv#aggregate" (the planes' upsampling, the fuse, the MLP and the
classifier), summed, over the number of spans "tpv#frame".

The stream's wall time between each span's CUDA event pair in the
profiled phase of a traced run: idle stretches included, not the
device's busy time."""

from verbench.program_spans import device_ms


def read(run):
    return device_ms("tpv#aggregate", per="tpv#frame")
