"""The whole operation's needed bytes (``portbench.peaks.assembly_bytes``)
at the HBM peak, over the calls' wall time (each call from entry until
its answer is ready, on the host's clock) in the traced run, in %:
the share that still bounds a gain after a kernel is taken off the
path."""
from portbench import tracing


def read(run):
    return None if run.trace is None else tracing.call_roofline_pct(run.trace)
