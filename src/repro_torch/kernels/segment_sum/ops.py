"""Sorted-stream segment sums: the dtype contract around B3'.

Counterpart of ``repro/kernels/segment_sum/ops.py``'s
``gather_segment_sum_sorted``.  The reference's VMEM residency guard
has no counterpart: the fused kernel serves every L.
"""
from __future__ import annotations

import torch

from ...sparse.pattern import accum_dtype, fill_dtype
from .segment_sum import gather_segment_sum


def gather_segment_sum_sorted(vals: torch.Tensor, perm: torch.Tensor,
                              slot: torch.Tensor, *,
                              num_segments: int) -> torch.Tensor:
    """Fused numeric phase: segment totals of ``vals[perm]`` masked by
    ``slot < num_segments``, without materializing the permuted stream.

    Output dtype follows :func:`repro_torch.sparse.pattern.fill_dtype`
    (inexact dtypes pass through, integers promote once to float32);
    16-bit float streams accumulate in float32
    (:func:`~repro_torch.sparse.pattern.accum_dtype`) and the totals are
    cast back.
    """
    dtype = fill_dtype(vals)
    if perm.shape[0] == 0:
        return torch.zeros(num_segments, dtype=dtype, device=vals.device)
    vals = vals.to(accum_dtype(dtype)).contiguous()
    return gather_segment_sum(vals, perm, slot,
                              num_segments=num_segments).to(dtype)
