"""Plain-PyTorch versions of the histogram kernel (B12).

Counterpart of ``repro/kernels/hist/ref.py``.  The CPU tests run them,
the wrapper takes them for CPU tensors, and ``chip_smoke.py`` holds the
CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from ..common import cdiv


def histogram_ref(keys: torch.Tensor, nbins: int) -> torch.Tensor:
    """Counts of keys in ``[0, nbins)``; out-of-range keys ignored."""
    keys = torch.where((keys >= 0) & (keys < nbins), keys, nbins).long()
    return torch.bincount(keys, minlength=nbins + 1)[:nbins].to(torch.int32)


def block_histogram_ref(keys: torch.Tensor, *, nbins: int,
                        block_b: int) -> torch.Tensor:
    """``int32[nblocks, nbins]``: row ``b`` counts keys ``[b * block_b,
    (b + 1) * block_b)``; keys outside ``[0, nbins)`` count nowhere."""
    L = keys.shape[0]
    nblocks = cdiv(L, block_b)
    block = torch.arange(L, device=keys.device) // block_b
    size = nblocks * nbins  # one extra bin collects out-of-range keys
    flat = torch.where((keys >= 0) & (keys < nbins),
                       block * nbins + keys.long(), size)
    hist = torch.zeros(size + 1, dtype=torch.int32, device=keys.device)
    hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist[:size].view(nblocks, nbins)
