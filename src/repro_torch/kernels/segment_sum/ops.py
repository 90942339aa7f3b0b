"""Sorted-stream segment reductions: the dtype contract around B3'-B6.

Counterpart of ``repro/kernels/segment_sum/ops.py``.  ``sum`` runs the
fused fill (B3'), ``mean`` divides its totals by the duplicate counts,
``min``/``max`` run the fused segment min/max (B4), ``first``/``last``
are one collision-free scatter of the boundary-flagged elements (no
kernel, as in the reference).  :func:`segment_sum_sorted` is the
unfused reduce: a prefix sum (B5) and the differences at segment
boundaries.  :func:`gather2_segment_sum_sorted` is the SpGEMM numeric
phase (B6).  Complex values on the card run through the float kernels
one real part at a time (sums and products are real-linear in each
part); ``min``/``max`` refuse complex values, as in the reference.

The reference's VMEM residency guard has no counterpart: its fused
kernels keep ``vals`` resident in an 8 MB VMEM budget and fall back to
a materialised stream past it (``ops.py:153-160``, ``350-358``); the
port's fused kernels gather from device memory and serve every L, so
those branches have no counterpart here.
"""
from __future__ import annotations

import torch

from ...sparse.pattern import (_slot_counts, accum_dtype, fill_dtype,
                               first_flags, last_flags, validate_accum)
from ..common import on_card_complex, split_complex
from .ref import segment_ends as _segment_ends  # noqa: F401
from .segment_sum import (blocked_cumsum, gather2_segment_sum,
                          gather_segment_minmax, gather_segment_sum)


def _segment_totals(c: torch.Tensor, first: torch.Tensor, *,
                    num_segments: int) -> torch.Tensor:
    """Per-segment totals from an inclusive prefix sum + boundary flags.

    ``totals[s] = c[end_s] - c[start_s - 1]``, with segment starts
    recovered by one collision-free scatter (each segment has one
    ``first``); segment ids past ``num_segments`` are dropped.  All
    traffic past the scatter is O(num_segments).
    """
    L = c.shape[0]
    dev = c.device
    seg = torch.cumsum(first.to(torch.int32), 0) - 1
    at = torch.where(first & (seg < num_segments), seg, num_segments).long()
    starts = torch.full((num_segments + 1,), L, dtype=torch.int64, device=dev)
    starts[at] = torch.arange(L, device=dev)
    starts = starts[:num_segments]
    # end of segment s = start of segment s+1 - 1 (last segment -> L-1)
    ends = torch.cat([starts[1:], starts.new_full((1,), L)]) - 1
    ends = torch.where(ends >= L, L - 1, ends)
    zero = torch.zeros((), dtype=c.dtype, device=dev)
    hi = torch.where(starts < L, c[ends.clamp(0, L - 1)], zero)
    lo = torch.where(starts > 0, c[(starts - 1).clamp(0, L - 1)], zero)
    lo = torch.where(starts < L, lo, zero)
    return hi - lo


def segment_sum_sorted(vals: torch.Tensor, first: torch.Tensor, *,
                       num_segments: int) -> torch.Tensor:
    """Per-segment totals of a stream whose duplicates are adjacent: one
    prefix sum (B5) and two size-``num_segments`` gathers."""
    if vals.shape[0] == 0:
        return vals.new_zeros(num_segments)
    if on_card_complex(vals.dtype, vals.device):
        c = split_complex(blocked_cumsum, vals)
    else:
        c = blocked_cumsum(vals.contiguous())
    return _segment_totals(c, first, num_segments=num_segments)


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
    return gather_segment_reduce_sorted(vals, perm, slot, accum="sum",
                                        num_segments=num_segments)


def gather2_segment_sum_sorted(vals_a: torch.Tensor, vals_b: torch.Tensor,
                               sa: torch.Tensor, sb: torch.Tensor,
                               slot: torch.Tensor, *,
                               num_segments: int) -> torch.Tensor:
    """Fused SpGEMM numeric phase: segment totals of the expansion
    product ``vals_a[sa] * vals_b[sb]`` masked by ``slot <
    num_segments``, without materializing the product stream (B6).

    ``sa``/``sb``/``slot`` are the sorted-order expansion maps of a
    :class:`~repro_torch.sparse.spgemm.ProductPattern`.  The dtype
    follows :func:`~repro_torch.sparse.pattern.fill_dtype` on the
    promoted operand dtype; 16-bit products accumulate in float32
    (:func:`~repro_torch.sparse.pattern.accum_dtype`) and the totals are
    cast back once.  Same run contract as
    :func:`gather_segment_reduce_sorted`.
    """
    dtype = fill_dtype(torch.promote_types(vals_a.dtype, vals_b.dtype))
    if sa.shape[0] == 0:
        return torch.zeros(num_segments, dtype=dtype, device=vals_a.device)
    acc = accum_dtype(dtype)
    if on_card_complex(dtype, sa.device):
        return split_complex(lambda a, b: gather2_segment_sum(
            a, b, sa, sb, slot, num_segments=num_segments), vals_a,
            vals_b).to(dtype)
    return gather2_segment_sum(vals_a.to(acc).contiguous(),
                               vals_b.to(acc).contiguous(), sa, sb, slot,
                               num_segments=num_segments).to(dtype)


def gather_segment_reduce_sorted(vals: torch.Tensor, perm: torch.Tensor,
                                 slot: torch.Tensor, *, accum: str = "sum",
                                 num_segments: int) -> torch.Tensor:
    """Masked sorted-segment reduction under any ``accum`` mode.

    Per-segment ``accum`` of ``vals[perm]`` masked by ``slot <
    num_segments``, with empty segments (the padded tail) holding
    structural zeros:

    ``sum``          the fused gather + segment-sum kernel (B3')
    ``mean``         ``sum`` totals / valid duplicate counts
    ``min``/``max``  the fused gather + segment min/max kernel (B4);
                     exact, so bit-identical to the reference's scan
    ``first``/``last``  one collision-free scatter of the flagged
                     elements (no kernel)

    The one implementation of the numeric phase: ``SparsePattern``'s
    fill and ``fill_fused`` run it.  16-bit floats go through the
    float32 kernels (``accum_dtype``) and are cast back once, after the
    ``mean`` division, as the reference's ``SparsePattern`` fill does
    (its kernel path casts the totals first and divides in 16 bits).
    A selection is exact in float32.

    Contract: every kept slot (``slot < num_segments``) forms one run of
    adjacent positions.  A plan's streams meet it for ``num_segments <=
    nzmax``.  Above that, the dropped inputs' sentinel ``slot == nzmax``
    would be kept, and its runs are not adjacent (they end each column):
    the kernels would race on that slot.
    """
    validate_accum(accum, vals.dtype)
    dtype = fill_dtype(vals)
    if perm.shape[0] == 0:
        return torch.zeros(num_segments, dtype=dtype, device=vals.device)
    if accum in ("first", "last"):
        keep = first_flags(slot, num_segments) if accum == "first" \
            else last_flags(slot, num_segments)
        out = torch.zeros(num_segments + 1, dtype=dtype, device=vals.device)
        out[torch.where(keep, slot, num_segments)] = vals[perm].to(dtype)
        return out[:num_segments]
    acc = accum_dtype(dtype)
    v = vals.to(acc).contiguous()
    if accum in ("min", "max"):
        out = gather_segment_minmax(v, perm, slot, num_segments=num_segments,
                                    op=accum)
    else:
        if on_card_complex(v.dtype, v.device):
            out = split_complex(lambda x: gather_segment_sum(
                x, perm, slot, num_segments=num_segments), v)
        else:
            out = gather_segment_sum(v, perm, slot,
                                     num_segments=num_segments)
        if accum == "mean":
            out = out / _slot_counts(num_segments, slot).clamp(min=1).to(acc)
    return out.to(dtype)
