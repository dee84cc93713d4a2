"""occupancy_span_ms.<cell>: device ms a span "ver#occupancy" of the
program (the upsampler, occ_proj and the occupancy MLP).

The stream's wall time between the span's CUDA event pair in the profiled
phase of a traced run: idle stretches included, not the device's busy
time, and longer for a host-bound span than without the profiler."""

from verbench.program_spans import device_ms


def read(run):
    return device_ms("ver#occupancy")
