"""Seconds from the start of the process to the first timed call:
imports, the kernels' build or load, the inputs made on the device,
the set-up of the operation and the warm-up."""


def read(run):
    return run.window.setup_s
