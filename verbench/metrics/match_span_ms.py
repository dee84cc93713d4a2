"""match_span_ms.<cell>: device ms of the program's spans "train#match"
(the matcher calls) a span "train#step".

The stream's wall time between each span's CUDA event pair in the profiled
phase of a traced run: idle stretches included, not the device's busy
time, and longer for a host-bound span than without the profiler.
Summed over a step's matcher calls: detection, and layout where the
configuration predicts it."""

from verbench.program_spans import device_ms


def read(run):
    return device_ms("train#match", per="train#step")
