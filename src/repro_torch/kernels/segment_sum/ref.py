"""Plain-PyTorch version of the fused fill kernel (B3').

The CPU tests run it, the kernel wrapper takes it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.  On the
CPU ``index_add_`` adds in index order, so each slot's sum is taken in
sorted-stream order, as the kernel takes it; on the card
``index_add_`` uses atomics and the order varies.
"""
from __future__ import annotations

import torch


def gather_segment_sum_ref(vals: torch.Tensor, perm: torch.Tensor,
                           slot: torch.Tensor, *,
                           num_segments: int) -> torch.Tensor:
    """``out[s] = sum(vals[perm[j]] for j with slot[j] == s)`` for every
    ``0 <= s < num_segments``; every other slot is dropped."""
    # dropped slots add into one scratch slot past the end (no
    # boolean-mask compaction, so no synchronisation with the device)
    keep = (slot >= 0) & (slot < num_segments)
    out = torch.zeros(num_segments + 1, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, torch.where(keep, slot, num_segments), vals[perm])
    return out[:num_segments]
