"""Mean device time of the plan's sort, Parts 1-2 (on the card the radix
sort's B1, scan and B2 passes), in ms: the CUDA events of the port's
``plan.sort`` spans over the traced window's calls."""
from portbench import program_spans


def read(run):
    return program_spans.mean_ms(run.trace, "plan.sort")
