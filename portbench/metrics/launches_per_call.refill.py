"""Device operations (kernels, copies, sets) a call launches, counted
from the profiler's trace of the window."""
from portbench import tracing


def read(run):
    return None if run.trace is None else tracing.launches_per_call(run.trace)
