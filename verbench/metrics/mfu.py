"""mfu.<cell>: the FLOP of the work the cell's path needs (its driver's
``flop_per_unit``, from verbench.flops) times the work completed, over
the span phase's seconds, as a share (%) of the peak of the
configuration's compute dtype (fp32 with TF32 off: the fp32 peak)."""

from verbench.readers import mfu


def read(run):
    return mfu(run, run.flop_per_unit)
