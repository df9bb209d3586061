"""Seconds from the process's start to the window's: imports, inputs
and weights, the kernels' build or load, the warm-up."""


def read(run):
    return run.setup_s
