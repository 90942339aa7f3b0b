"""Random streams drawn from the run's ``--seed``.

Each stream (a pattern, a value vector, the choice of answers to check,
the column offsets of fresh patterns)
has a ``torch.Generator`` of its own, on the device that draws it, so
the same seed gives the same inputs whatever else the run does.
"""
from __future__ import annotations

import numpy as np
import torch

#: stream names, so that two streams never share a generator
PATTERN, VALUES, SAMPLE, OFFSET = 0, 1, 2, 3


def state(seed: int, *stream: int) -> int:
    """A 63-bit seed for ``(seed, *stream)``; any whole ``seed``."""
    words = [int(seed) % 2**64, *(int(s) for s in stream)]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *stream: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(state(seed, *stream))
    return g


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(state(seed, *stream))
