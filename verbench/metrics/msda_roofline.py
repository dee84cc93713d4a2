"""msda_roofline.<cell>: the share (%) of the gather kernel's least time
in its device time, over its traced launches (by its symbol,
``msda_gather_kernel``).  The least time of a launch is its bytes read
and written once, or the fp32 operations on its samples, whichever
bounds, at the launch's own shapes (``verbench/bevformer_flops.py``); a
frame's launches are the driver's ``msda_launches_per_frame``, their least
seconds ``msda_least_s_per_frame``."""

KERNEL = "msda_gather_kernel"


def read(run):
    if run.trace is None:
        return None
    secs, launches = run.trace.kernel_s(KERNEL)
    per = run.counters.get("msda_launches_per_frame")
    least = run.counters.get("msda_least_s_per_frame")
    if not launches or secs <= 0 or not per or least is None:
        return None
    return 100.0 * least * launches / per / secs
