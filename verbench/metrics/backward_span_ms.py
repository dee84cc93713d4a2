"""backward_span_ms.<cell>: device ms a span "train#backward" of the
program (zero_grad and the backward).

The stream's wall time between the span's CUDA event pair in the profiled
phase of a traced run: idle stretches included, not the device's busy
time, and longer for a host-bound span than without the profiler."""

from verbench.program_spans import device_ms


def read(run):
    return device_ms("train#backward")
