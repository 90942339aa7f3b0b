"""The 95th percentile over all the window's calls of one call, from
entry until its CSC is ready (CUDA events: the device's clock, the
host's dispatch gaps included)."""
import numpy as np


def read(run):
    ms = run.window.call_ms
    return float(np.percentile(ms, 95)) if ms else None
