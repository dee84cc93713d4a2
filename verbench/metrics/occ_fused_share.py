"""occ_fused_share.<cell>: the share (%) of the occupancy head's even-cell
calls (the program's counter "occ#calls") that the occupancy MLP kernel
served ("occ#fused_calls"; traced run)."""

from verbench.program_spans import counter


def read(run):
    calls = counter("occ#calls")
    if not calls:
        return None
    return 100.0 * (counter("occ#fused_calls") or 0.0) / calls
