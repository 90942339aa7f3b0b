"""CUDA runtime calls that block the host, begun inside the port's own
``fill`` spans, a call."""
from portbench import program_spans


def read(run):
    return program_spans.syncs_per_call(run.trace)
