"""auction_iters.<cell>: the program's counter "match#auction_iterations"
(iterations the auction matcher ran) a span "train#step" (traced run)."""

from verbench.program_spans import counter


def read(run):
    return counter("match#auction_iterations", per="train#step")
