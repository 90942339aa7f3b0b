"""Peak device memory allocated during the window, less what the caller
held when it began (inputs, plan, the last answer) and less the answer
kept for the check, in 10^6 bytes (the CUDA caching allocator's
counters)."""


def read(run):
    b = run.window.workspace_bytes
    return None if b is None else b / 1e6
