"""What the metric readers (``verbench/metrics/<metric>.py``) share.
Each returns a number, or None where the run has nothing to read."""

from __future__ import annotations

from .flops import PEAK_FLOP_PER_S, deform_least_s

FWD_KERNEL = "deform_attn_2d_kernel"
BWD_KERNEL = "deform_attn_2d_backward_kernel"


def rate(run):
    """Work completed over the window's seconds."""
    return run.units / run.window_s


def span(run, name):
    return run.spans.get(name)


def mfu(run, flop_per_unit):
    """The window's FLOP over its seconds, as a share (%) of the peak of
    the configuration's compute dtype (fp32 with TF32 off: the fp32
    peak)."""
    if not run.units:
        return None
    return (100.0 * flop_per_unit * run.units / run.window_s
            / PEAK_FLOP_PER_S[run.arch.dtype])


def device_idle(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def deform_roofline(run, backward=False):
    """Least time of the traced launches of the lift's kernel (bytes or
    fp32 operations on the valid taps, whichever bounds) over their
    device time, in %."""
    if run.trace is None:
        return None
    secs, launches = run.trace.kernel_s(BWD_KERNEL if backward
                                        else FWD_KERNEL)
    taps = run.counters.get("valid_taps_per_view_layer")
    if not launches or secs <= 0 or taps is None:
        return None
    b = run.counters["batch"]
    least = launches * deform_least_s(run.arch, b, taps * b, backward)
    return 100.0 * least / secs
