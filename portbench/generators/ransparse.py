"""The paper's benchmark data (Listing 12, ``ransparse``), on the device.

``siz`` rows of ``nnz_row`` entries each in uniformly random columns,
the whole set repeated ``nrep`` times and the triplets shuffled.  The
indices are zero-offset (Matlab's ``ii - 1``, ``jj - 1``).  The paper's
values are ones; here they are float32, uniform on ``cfg["values"]``,
so that no two value vectors are alike.
"""
from __future__ import annotations

import torch

from .. import seeding


def shape(cfg: dict) -> tuple[int, int]:
    return cfg["siz"], cfg["siz"]


def length(cfg: dict) -> int:
    return cfg["siz"] * cfg["nnz_row"] * cfg["nrep"]


def pattern(cfg: dict, seed: int, index: int, device):
    """Zero-offset int32 ``(rows, cols)`` of draw ``index``."""
    siz, per_row, nrep = cfg["siz"], cfg["nnz_row"], cfg["nrep"]
    g = seeding.generator(seed, seeding.PATTERN, index, device=device)
    ii = torch.arange(siz, dtype=torch.int32, device=device)
    ii = ii.repeat_interleave(per_row)
    jj = torch.randint(0, siz, (siz * per_row,), generator=g,
                       dtype=torch.int32, device=device)
    ii, jj = ii.repeat(nrep), jj.repeat(nrep)
    p = torch.randperm(ii.numel(), generator=g, device=device)
    return ii[p], jj[p]


#: each index of a configuration draws a pattern of its own
SHARED_PATTERN = False


def values(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    lo, hi = cfg["values"]
    g = seeding.generator(seed, seeding.VALUES, index, device=device)
    out = torch.empty(length(cfg), dtype=torch.float32, device=device)
    return out.uniform_(lo, hi, generator=g)
