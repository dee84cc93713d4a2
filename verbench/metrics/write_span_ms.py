"""write_span_ms.<cell>: host ms a span "ver_writer#write" of the program
(one volume's deflate and HDF5 write on the writer thread),
in the profiled phase of a traced run."""

from verbench.program_spans import host_ms


def read(run):
    return host_ms("ver_writer#write")
