"""Mean device time of the plan's Parts 3-4 (``pattern_from_perm``: the
sorted keys' gathers, the boundary flags and their scan, the searches
for ``indices`` and ``indptr``), in ms: the CUDA events of the port's
``plan.parts34`` spans over the traced window's calls."""
from portbench import program_spans


def read(run):
    return program_spans.mean_ms(run.trace, "plan.parts34")
