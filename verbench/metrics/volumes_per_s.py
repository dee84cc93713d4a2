"""volumes_per_s: the work completed in the window over its seconds (volumes
or samples; the dump counts the volumes written)."""

from verbench.readers import rate


def read(run):
    return rate(run)
