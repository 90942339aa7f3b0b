"""Triplet values summed into the held plan's CSC a second, in
millions: all the window's calls over all its time on the host's
clock."""


def read(run):
    w = run.window
    return w.work / w.seconds / 1e6 if w.seconds > 0 else None
