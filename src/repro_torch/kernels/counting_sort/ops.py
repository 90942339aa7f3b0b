"""The counting sort built from the histogram and placement kernels.

Counterpart of ``repro/kernels/counting_sort/ops.py``: Part 1 (B12 and
the scans of :func:`~repro_torch.kernels.hist.ops.block_offsets`), Part
2 (B11), and the final ``rank[pos] = arange(L)`` scatter, which stays
plain PyTorch as the reference leaves it to XLA.
"""
from __future__ import annotations

import torch

from ..hist.ops import block_offsets, default_block_b
from .counting_sort import placement


def counting_sort(keys: torch.Tensor, *, nbins: int,
                  block_b: int | None = None):
    """Stable distribution counting sort of int keys in ``[0, nbins)``.

    Returns ``(rank, positions)``: ``keys[rank]`` is sorted stably and
    ``rank[positions[i]] == i``.  ``block_b=None`` takes
    :func:`~repro_torch.kernels.hist.ops.default_block_b` (the
    ``counting_sort`` tuning policy); the result does not depend on it.
    """
    L = keys.shape[0]
    keys = keys.to(torch.int32).contiguous()
    if L == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=keys.device)
        return empty, empty.clone()
    if block_b is None:
        block_b = default_block_b(nbins, L=L, backend=keys.device)
    offsets, _ = block_offsets(keys, nbins=nbins, block_b=block_b)
    pos = placement(keys, offsets, nbins=nbins, block_b=block_b,
                    consume_offsets=True)
    rank = torch.empty(L, dtype=torch.int32, device=keys.device)
    rank[pos] = torch.arange(L, dtype=torch.int32, device=keys.device)
    return rank, pos
