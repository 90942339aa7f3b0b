"""Mean time of the plan layer call, in ms, from its span's CUDA events
over the traced window's calls."""
from portbench import tracing


def read(run):
    if run.trace is None:
        return None
    return tracing.span_mean_ms(run.trace, "plan")
