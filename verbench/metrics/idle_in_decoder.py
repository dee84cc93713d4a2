"""idle_in_decoder.<cell>: the share (%) of the traced window with the device
idle while the calling thread was in a span "ver#decoder" of the program
(the decoder), by ``verbench.program_spans``' rule."""

from verbench.program_spans import idle_in


def read(run):
    return idle_in(run, "ver#decoder")
