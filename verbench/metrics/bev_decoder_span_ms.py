"""bev_decoder_span_ms.<cell>: device ms a frame in the program's spans
"bev#decoder" (the decoder over the BEV and its reference points),
summed, over the number of spans "bev#frame".

The stream's wall time between each span's CUDA event pair in the
profiled phase of a traced run: idle stretches included, not the
device's busy time."""

from verbench.program_spans import device_ms


def read(run):
    return device_ms("bev#decoder", per="bev#frame")
