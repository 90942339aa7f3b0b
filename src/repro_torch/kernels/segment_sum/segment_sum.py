"""Wrappers of the numeric phase's CUDA kernels (``csrc/segment_sum.cu``).

``gather_segment_sum`` (B3') computes what the Pallas
``gather_masked_cumsum`` of ``repro/kernels/segment_sum/segment_sum.py``
feeds into its ``_segment_totals`` epilogue, in one kernel: the
per-segment sums of ``vals[perm]`` over a sorted slot stream, with
every ``slot >= num_segments`` dropped.  It reduces each segment
directly instead of differencing a global prefix sum: one launch of a
single-pass segmented reduction whose tiles carry the run open at their
end through a decoupled look-back, so a run of any length is reduced by
every tile it spans.

``gather_segment_minmax`` (B4) is the counterpart of
``gather_masked_segscan`` read at each segment's end: the per-segment
min or max on B3''s kernel with the min/max operator, with 0 in empty
slots.

``blocked_cumsum`` (B5) is the counterpart of ``blocked_cumsum``: an
inclusive prefix sum, one launch of a single-pass scan with decoupled
look-back.

``gather2_segment_sum`` (B6) is the counterpart of
``gather2_masked_cumsum`` with its ``_segment_totals`` epilogue: the
SpGEMM numeric phase, per-segment sums of ``vals_a[sa] * vals_b[sb]``
over a product plan's sorted slot stream, on B3''s kernel with two
gathers a position (tiles of ``PRODUCT_TILE`` positions).

Each wrapper takes its plain version (:mod:`.ref`) for a CPU tensor and
launches its kernel for a CUDA tensor; ``.launches`` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import (bind, cdiv, check_cuda_tensor, check_launch,
                      current_stream, load_library)
from .ref import (PRODUCT_TILE, SCAN_TILE, SEG_TILE, blocked_cumsum_ref,
                  gather2_segment_sum_ref, gather_segment_minmax_ref,
                  gather_segment_sum_ref)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FNS: dict = {}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _fns() -> dict:
    if not _FNS:
        lib = load_library("segment_sum")
        for fn, want in (("scan_tile", SCAN_TILE),
                         ("segment_tile", SEG_TILE),
                         ("product_tile", PRODUCT_TILE)):
            bind(lib, fn, [])
            if getattr(lib, fn)() != want:
                raise RuntimeError(f"csrc/segment_sum.cu: {fn}() differs "
                                   "from the segment_sum tuning spec")
        for dtype, sfx in _SUFFIX.items():
            _FNS["sum", dtype] = bind(lib, f"gather_segment_sum_{sfx}_launch",
                                      [_P, _P, _P, _P, _P, _LL, _LL, _P])
            _FNS["minmax", dtype] = bind(
                lib, f"gather_segment_minmax_{sfx}_launch",
                [_P, _P, _P, _P, _P, _LL, _LL, _I, _P])
            _FNS["cumsum", dtype] = bind(lib, f"blocked_cumsum_{sfx}_launch",
                                         [_P, _P, _P, _LL, _P])
            _FNS["sum2", dtype] = bind(
                lib, f"gather2_segment_sum_{sfx}_launch",
                [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _P])
    return _FNS


def _check_values(vals: torch.Tensor, what: str) -> None:
    if vals.is_complex():
        raise NotImplementedError(
            f"{what} takes float32/float64: complex values reach it as "
            "real parts through the ops layer (common.split_complex)"
        )
    check_cuda_tensor(vals, "vals", tuple(_SUFFIX))


def _check_index_stream(perm, slot, name: str = "perm") -> int:
    check_cuda_tensor(perm, name, (torch.int32,))
    check_cuda_tensor(slot, "slot", (torch.int32,))
    L = perm.shape[0]
    if perm.ndim != 1 or slot.shape != perm.shape or L == 0 or L >= 2**31:
        raise ValueError(
            f"{name} and slot must be equal 1-d streams with 0 < L < 2^31, "
            f"got {tuple(perm.shape)} and {tuple(slot.shape)}"
        )
    return L


def _check_stream(vals, perm, slot, what: str) -> int:
    _check_values(vals, what)
    L = _check_index_stream(perm, slot)
    if tuple(vals.shape) != (L,):
        # the kernel reads vals[perm[k]] with no bounds check
        raise ValueError(f"vals has shape {tuple(vals.shape)}, expected "
                         f"({L},): one value per stream position")
    return L


def _scratch_words(L: int, tile: int, dtype: torch.dtype) -> int:
    """64-bit words of a look-back kernel's zeroed scratch: the tile
    ticket, then one descriptor a tile (two words in float32, a flag and
    three values in float64)."""
    return 1 + cdiv(L, tile) * (2 if dtype == torch.float32 else 4)


def _zeros_and_scratch(n: int, dtype: torch.dtype, L: int, device,
                       tile: int = SEG_TILE):
    """A zeroed output of ``n`` values and a fill kernel's zeroed scratch
    for tiles of ``tile`` positions (B3''s and B4's by default, B6's
    ``PRODUCT_TILE``), cut from one allocation so that a call zeroes
    memory once."""
    words = _scratch_words(L, tile, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    buf = torch.zeros(words + cdiv(n * size, 8), dtype=torch.int64,
                      device=device)
    return buf[words:].view(dtype)[:n], buf[:words]


def gather_segment_sum(vals: torch.Tensor, perm: torch.Tensor,
                       slot: torch.Tensor, *,
                       num_segments: int) -> torch.Tensor:
    """B3': ``[num_segments]`` sums of ``vals[perm]`` per sorted slot run.

    ``perm``/``slot`` are a plan's int32 streams (equal slots adjacent);
    ``vals`` is float32 or float64 on the card (the caller casts 16-bit
    values to float32 first and splits complex ones into real parts).

    Each kept slot (``< num_segments``) must be one run of adjacent
    positions: the position that ends a run writes its slot.  A plan's
    streams meet that for ``num_segments <= nzmax`` only; with more, the
    dropped inputs' ``slot == nzmax`` runs (one per column) would all
    write that slot.  Deterministic: the same inputs give the same bits.
    """
    if vals.device.type == "cpu":
        return gather_segment_sum_ref(vals, perm, slot,
                                      num_segments=num_segments)
    L = _check_stream(vals, perm, slot, "the fused fill")
    out, scratch = _zeros_and_scratch(num_segments, vals.dtype, L,
                                      vals.device)
    check_launch(_fns()["sum", vals.dtype](
        vals.data_ptr(), perm.data_ptr(), slot.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), L, num_segments, current_stream(vals.device)),
        "gather_segment_sum")
    gather_segment_sum.launches += 1
    return out


def gather_segment_minmax(vals: torch.Tensor, perm: torch.Tensor,
                          slot: torch.Tensor, *, num_segments: int,
                          op: str) -> torch.Tensor:
    """B4: ``[num_segments]`` min (``op="min"``) or max (``"max"``) of
    ``vals[perm]`` per sorted slot run; 0 in every empty slot, NaN
    propagates.  Same streams, dtypes and contract (``num_segments <=``
    the plan's ``nzmax``) as :func:`gather_segment_sum`.
    """
    if op not in ("min", "max"):
        raise ValueError(f"op must be 'min' or 'max', got {op!r}")
    if vals.device.type == "cpu":
        return gather_segment_minmax_ref(vals, perm, slot,
                                         num_segments=num_segments, op=op)
    L = _check_stream(vals, perm, slot, "the min/max fill")
    out, scratch = _zeros_and_scratch(num_segments, vals.dtype, L,
                                      vals.device)
    check_launch(_fns()["minmax", vals.dtype](
        vals.data_ptr(), perm.data_ptr(), slot.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), L, num_segments, int(op == "max"),
        current_stream(vals.device)), "gather_segment_minmax")
    gather_segment_minmax.launches += 1
    return out


def gather2_segment_sum(vals_a: torch.Tensor, vals_b: torch.Tensor,
                        sa: torch.Tensor, sb: torch.Tensor,
                        slot: torch.Tensor, *,
                        num_segments: int) -> torch.Tensor:
    """B6: ``[num_segments]`` sums of ``vals_a[sa] * vals_b[sb]`` per
    sorted slot run.

    ``sa``/``sb``/``slot`` are a product plan's int32 sorted-order
    streams; ``vals_a``/``vals_b`` are the operands' ``data`` vectors, of
    one dtype, float32 or float64 on the card (the caller casts 16-bit
    values to float32 and splits complex ones into real parts).  The
    kernel reads ``vals_a[sa[k]]`` and ``vals_b[sb[k]]`` unchecked: the
    caller checks the operand lengths against the plan's capacities.
    Same run contract as :func:`gather_segment_sum` (``num_segments <=``
    the plan's ``nzmax``).  One launch; deterministic, each product
    rounded before it is added.
    """
    if vals_a.device.type == "cpu":
        return gather2_segment_sum_ref(vals_a, vals_b, sa, sb, slot,
                                       num_segments=num_segments)
    _check_values(vals_a, "the product fill")
    check_cuda_tensor(vals_b, "vals_b", (vals_a.dtype,))
    if vals_a.ndim != 1 or vals_b.ndim != 1:
        raise ValueError("vals_a and vals_b must be 1-d")
    L = _check_index_stream(sa, slot, "sa")
    check_cuda_tensor(sb, "sb", (torch.int32,))
    if sb.shape != sa.shape:
        raise ValueError(f"sb has shape {tuple(sb.shape)}, expected "
                         f"{tuple(sa.shape)}")
    out, scratch = _zeros_and_scratch(num_segments, vals_a.dtype, L,
                                      vals_a.device, PRODUCT_TILE)
    check_launch(_fns()["sum2", vals_a.dtype](
        vals_a.data_ptr(), vals_b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
        slot.data_ptr(), out.data_ptr(), scratch.data_ptr(), L, num_segments,
        current_stream(vals_a.device)), "gather2_segment_sum")
    gather2_segment_sum.launches += 1
    return out


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """B5: inclusive prefix sum of a 1-d float32/float64 tensor; empty
    ``x`` gives an empty result with no launch."""
    if x.device.type == "cpu":
        return blocked_cumsum_ref(x)
    _check_values(x, "the prefix sum")
    L = x.shape[0]
    if x.ndim != 1 or L >= 2**31:
        raise ValueError(f"x must be 1-d with L < 2^31, got "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    if L == 0:
        return out
    scratch = torch.zeros(_scratch_words(L, SCAN_TILE, x.dtype),
                          dtype=torch.int64, device=x.device)
    check_launch(_fns()["cumsum", x.dtype](
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), L,
        current_stream(x.device)), "blocked_cumsum")
    blocked_cumsum.launches += 1
    return out


gather_segment_sum.launches = 0
gather2_segment_sum.launches = 0
gather_segment_minmax.launches = 0
blocked_cumsum.launches = 0
