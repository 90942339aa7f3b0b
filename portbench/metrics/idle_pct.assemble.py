"""Share of the traced window in which no operation ran on the device."""
from portbench import tracing


def read(run):
    return None if run.trace is None else tracing.idle_pct(run.trace)
