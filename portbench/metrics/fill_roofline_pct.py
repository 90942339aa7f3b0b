"""The fill layer's needed bytes (``portbench.peaks``) at the HBM peak,
over the device's busy time inside its spans, in %."""
from portbench import tracing


def read(run):
    if run.trace is None:
        return None
    return tracing.span_roofline_pct(run.trace, "fill")
