"""idle_in_match.<cell>: the share (%) of the traced window with the device
idle while the calling thread was in a span "train#match" of the program
(the matcher), by ``verbench.program_spans``' rule."""

from verbench.program_spans import idle_in


def read(run):
    return idle_in(run, "train#match")
