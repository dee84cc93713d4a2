"""up_fused_share.<cell>: the share (%) of the upsampler's calls (the
program's counter "up#calls") in which every stage took the assembly
kernel ("up#fused_calls"; traced run)."""

from verbench.program_spans import counter


def read(run):
    calls = counter("up#calls")
    if not calls:
        return None
    return 100.0 * (counter("up#fused_calls") or 0.0) / calls
