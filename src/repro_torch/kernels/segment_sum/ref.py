"""Plain-PyTorch versions of the numeric phase's kernels (B3', B4, B5, B6).

The CPU tests run them, the kernel wrappers take them for CPU tensors,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.
None of them synchronises with the device (no boolean-mask compaction).
Counterpart of ``repro/kernels/segment_sum/ref.py`` (``cumsum_ref``,
``segment_sum_sorted_ref``, ``gather2_segment_sum_sorted_ref`` as
:func:`gather2_segment_sum_ref`, ``segment_reduce_sorted_ref``) plus the
plain versions of the port's kernels.
"""
from __future__ import annotations

import torch

from ...sparse import tuning
from ...sparse.pattern import accum_identity, first_flags, last_flags
from ..common import cdiv, pad_to

_BUILT = tuning.build_knobs("segment_sum")
#: values per tile of the B5 scan (256 threads x 16) -- fixed by
#: ``csrc/segment_sum.cu`` (the ``segment_sum`` spec's build-time knobs)
SCAN_TILE = _BUILT["threads"] * _BUILT["scan_per"]
#: sorted positions per tile of B3' and B4 (256 threads x 8)
SEG_TILE = _BUILT["threads"] * _BUILT["seg_per"]
#: sorted product positions per tile of B6 (256 threads x 8)
PRODUCT_TILE = _BUILT["threads"] * _BUILT["sum2_per"]


def cumsum_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0)


def segment_sum_sorted_ref(vals: torch.Tensor, first: torch.Tensor, *,
                           num_segments: int) -> torch.Tensor:
    """Segment totals of a sorted stream; segments delimited by
    ``first`` (segment ids past ``num_segments`` are dropped)."""
    seg = torch.cumsum(first.to(torch.int32), 0) - 1
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = vals.new_zeros(num_segments + 1)
    out.index_add_(0, seg, vals)
    return out[:num_segments]


def gather_segment_sum_ref(vals: torch.Tensor, perm: torch.Tensor,
                           slot: torch.Tensor, *,
                           num_segments: int) -> torch.Tensor:
    """B3': ``out[s] = sum(vals[perm[j]] for j with slot[j] == s)`` for
    every ``0 <= s < num_segments``; every other slot is dropped.

    On the CPU ``index_add_`` adds in index order, so each slot's sum is
    taken in sorted-stream order, as the kernel takes it; on the card
    ``index_add_`` uses atomics and the order varies.
    """
    # dropped slots add into one scratch slot past the end (no
    # boolean-mask compaction, so no synchronisation with the device)
    keep = (slot >= 0) & (slot < num_segments)
    out = torch.zeros(num_segments + 1, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, torch.where(keep, slot, num_segments), vals[perm])
    return out[:num_segments]


def gather2_segment_sum_ref(vals_a: torch.Tensor, vals_b: torch.Tensor,
                            sa: torch.Tensor, sb: torch.Tensor,
                            slot: torch.Tensor, *,
                            num_segments: int) -> torch.Tensor:
    """B6: ``out[s] = sum(vals_a[sa[j]] * vals_b[sb[j]] for j with
    slot[j] == s)`` for every ``0 <= s < num_segments``; every other
    slot is dropped.  Each product is rounded before it is added, as the
    kernel rounds it.  On the CPU ``index_add_`` adds in sorted-stream
    order; the kernel adds each run in its tiles' order (B3''s), so the
    two agree bit for bit where every sum is exact (integer-valued data
    below 2^24, 2^53 in float64) and within r eps sum|terms| for a run of
    r terms elsewhere."""
    keep = (slot >= 0) & (slot < num_segments)
    out = torch.zeros(num_segments + 1, dtype=vals_a.dtype,
                      device=vals_a.device)
    out.index_add_(0, torch.where(keep, slot, num_segments),
                   vals_a[sa] * vals_b[sb])
    return out[:num_segments]


def segment_ends(slot: torch.Tensor, *, num_segments: int) -> torch.Tensor:
    """Sorted-stream position of each segment's last element (-1: empty)."""
    L = slot.shape[0]
    ends = torch.full((num_segments + 1,), -1, dtype=torch.int64,
                      device=slot.device)
    at = torch.where((slot >= 0) & (slot < num_segments), slot,
                     num_segments).long()
    ends.scatter_reduce_(0, at, torch.arange(L, device=slot.device), "amax")
    return ends[:num_segments].to(torch.int32)


def segmented_scan_ref(v: torch.Tensor, first: torch.Tensor, *,
                       op: str) -> torch.Tensor:
    """Inclusive segmented min/max scan, segments starting at ``first``.

    The reference kernel's Hillis-Steele ladder over ``(value,
    started)`` pairs, on the whole stream at once: log2(L) steps of
    ``where(f, v, op(v[i - d], v))``.  ``torch.minimum``/``maximum``
    propagate NaN, as ``jnp.minimum``/``maximum`` do.
    """
    fn = torch.minimum if op == "min" else torch.maximum
    ident = accum_identity(op, v.dtype).to(v.device)
    f = first.to(torch.bool)
    L, d = v.shape[0], 1
    while d < L:
        pv = torch.cat([ident.expand(d), v[:-d]])
        pf = torch.cat([f.new_zeros(d), f[:-d]])
        v = torch.where(f, v, fn(pv, v))
        f = f | pf
        d *= 2
    return v


def gather_segment_minmax_ref(vals: torch.Tensor, perm: torch.Tensor,
                              slot: torch.Tensor, *, num_segments: int,
                              op: str) -> torch.Tensor:
    """B4: ``out[s]`` = min (``op="min"``) or max of ``vals[perm[j]]``
    over the positions with ``slot[j] == s < num_segments``; 0 in every
    empty slot.

    The reference's route: mask padding to the identity, run the
    segmented scan, and read it at each segment's end.
    """
    if perm.shape[0] == 0:
        return vals.new_zeros(num_segments)
    keep = (slot >= 0) & (slot < num_segments)
    v = torch.where(keep, vals[perm],
                    accum_identity(op, vals.dtype).to(vals.device))
    prev = torch.cat([slot.new_full((1,), -1), slot[:-1]])
    scan = segmented_scan_ref(v, keep & (slot != prev), op=op)
    ends = segment_ends(slot, num_segments=num_segments)
    red = scan[ends.clamp(min=0).long()]
    return torch.where(ends >= 0, red, torch.zeros((), dtype=vals.dtype,
                                                   device=vals.device))


def segment_reduce_sorted_ref(vals: torch.Tensor, perm: torch.Tensor,
                              slot: torch.Tensor, *, accum: str,
                              num_segments: int) -> torch.Tensor:
    """Plain masked sorted-segment reductions under every ``accum`` mode
    (the reference's ``segment_reduce_sorted_ref``), on scatter ops only."""
    v = vals[perm]
    valid = (slot >= 0) & (slot < num_segments)
    ids = torch.where(valid, slot, num_segments).long()
    counts = torch.zeros(num_segments + 1, dtype=torch.int32,
                         device=vals.device)
    counts.index_add_(0, ids, valid.to(torch.int32))
    counts = counts[:num_segments]
    if accum in ("sum", "mean"):
        s = v.new_zeros(num_segments + 1).index_add_(
            0, ids, torch.where(valid, v, torch.zeros((), dtype=v.dtype)))
        s = s[:num_segments]
        if accum == "sum":
            return s
        return s / counts.clamp(min=1).to(v.dtype)
    if accum in ("min", "max"):
        red = v.new_zeros(num_segments + 1).scatter_reduce_(
            0, ids, v, "amin" if accum == "min" else "amax",
            include_self=False)[:num_segments]
        return torch.where(counts > 0, red, torch.zeros((), dtype=v.dtype))
    keep = first_flags(slot, num_segments) if accum == "first" \
        else last_flags(slot, num_segments)
    out = v.new_zeros(num_segments + 1)
    out[torch.where(keep, slot, num_segments).long()] = v
    return out[:num_segments]


def blocked_cumsum_ref(x: torch.Tensor) -> torch.Tensor:
    """B5: inclusive prefix sum by the kernel's route.

    Tiles of :data:`SCAN_TILE` values: each tile's sum, the tiles'
    exclusive prefixes, then each tile's own scan plus its prefix.  The
    kernel chains the prefixes through a look-back, in more precision
    than the data, and adds inside a tile in another order; exact on
    integer-valued data below 2^24.
    """
    L = x.shape[0]
    ntiles = cdiv(L, SCAN_TILE)
    tiles = pad_to(x, ntiles * SCAN_TILE, 0).view(ntiles, SCAN_TILE)
    sums = tiles.sum(1)
    offs = torch.cat([sums.new_zeros(1), torch.cumsum(sums, 0)[:-1]])
    return (offs[:, None] + torch.cumsum(tiles, 1)).reshape(-1)[:L]


#: the reference's name (``repro.kernels.segment_sum.ref``)
gather2_segment_sum_sorted_ref = gather2_segment_sum_ref
