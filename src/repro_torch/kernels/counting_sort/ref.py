"""Plain-PyTorch versions of counting-sort placement (B11).

Counterpart of ``repro/kernels/counting_sort/ref.py`` plus the plain
version of the kernel given a block-offset table.  The CPU tests run
them, the wrapper takes them for CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def placement_ref(keys: torch.Tensor, offsets: torch.Tensor, *, nbins: int,
                  block_b: int) -> torch.Tensor:
    """``pos[i] = offsets[b, key_i] + (keys equal to key_i earlier in
    block b)`` with ``b = i // block_b``; -1 for keys outside ``[0,
    nbins)``.

    With ``offsets`` from :func:`repro_torch.kernels.hist.ops
    .block_offsets` at the same ``block_b`` this is the landing position
    of every key in a stable sort.
    """
    L = keys.shape[0]
    dev = keys.device
    inside = (keys >= 0) & (keys < nbins)
    block = torch.arange(L, device=dev) // block_b
    size = offsets.numel()
    # (block, key) groups in input order; out-of-range keys form one
    # trailing group
    group = torch.where(inside, block * nbins + keys.long(), size)
    order = torch.sort(group, stable=True).indices
    g = group[order]
    rank = torch.arange(L, device=dev) - torch.searchsorted(g, g,
                                                             side="left")
    base = offsets.reshape(-1).long()[g.clamp(max=max(size - 1, 0))]
    pos = torch.empty(L, dtype=torch.int32, device=dev)
    pos[order] = torch.where(g < size, base + rank, -1).to(torch.int32)
    return pos


def counting_sort_ref(keys: torch.Tensor):
    """``(rank, positions)``: ``rank`` is the stable argsort permutation,
    ``positions`` its inverse."""
    rank = torch.sort(keys, stable=True).indices.to(torch.int32)
    pos = torch.empty_like(rank)
    pos[rank] = torch.arange(keys.shape[0], dtype=torch.int32,
                             device=keys.device)
    return rank, pos
