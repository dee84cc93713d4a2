"""setup_s: process start to the first timed call, in seconds."""


def read(run):
    return run.setup_s
