"""device_idle.<cell>: the share (%) of the traced window with nothing
running on the device (union of the trace's device intervals)."""

from verbench.readers import device_idle


def read(run):
    return device_idle(run)
