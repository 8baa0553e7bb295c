"""Seconds from the start of the process to the first timed request:
importing, making the weights, loading the kernels, warming up and
capturing."""


def read(run):
    return run.setup_s
