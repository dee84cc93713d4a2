"""deform_fwd_roofline.<cell>: the lift's forward kernel against its
least time, in % (traced run)."""

from verbench.readers import deform_roofline


def read(run):
    return deform_roofline(run)
