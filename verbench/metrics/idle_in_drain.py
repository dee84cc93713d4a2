"""idle_in_drain.<cell>: the share (%) of the traced window with the device
idle while the calling thread was in a span "ver_writer#drain" of the program
(the dump's wait for its writer), by ``verbench.program_spans``' rule."""

from verbench.program_spans import idle_in


def read(run):
    return idle_in(run, "ver_writer#drain")
