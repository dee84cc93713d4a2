"""decoder_graph_share.<cell>: the share (%) of the decoder's forwards
(the program's counter "decoder#calls") that replayed a CUDA graph
("decoder#graph_replays"; traced run)."""

from verbench.program_spans import counter


def read(run):
    calls = counter("decoder#calls")
    if not calls:
        return None
    return 100.0 * (counter("decoder#graph_replays") or 0.0) / calls
