"""End-to-end kernel-backed sparse assembly (the H100 production path).

Counterparts of ``repro/kernels/assembly_ops.py``'s ``plan_pallas``,
``fill_fused`` and ``assemble_pallas``, renamed because nothing in the
port is Pallas (the reference's names stay as aliases):

  Parts 1-2  radix_sort.radix_sort_pair  (B1 histogram + scan + B2
             placement per digit of at most 8 bits)
  Parts 3-4  pattern_build.pattern_build (one pass: the sorted keys, the
             boundary flags and their scan, slots, indices, indptr)
  Numeric    segment_sum.gather_segment_reduce_sorted (B3': gather +
             mask + segment sum in one kernel; B4 the same for
             min/max)
  Product    segment_sum.gather2_segment_sum_sorted (B6: both operand
             gathers, the multiply, mask and segment sum in one kernel)
  Sharded    the routed values of a ``ShardedPattern`` through B3' (one
             launch over the row blocks' streams), ``fill_sharded_pallas``

``fill_pallas`` keeps the reference's unfused reduce for comparison:
the gathered stream is written out, then prefix-summed (B5) and
differenced at the segment boundaries.  On CPU tensors every kernel
runs its plain version.
"""
from __future__ import annotations

import torch

from ..core.csc import CSC
from ..sparse.dispatch import sorted_permutation
from ..sparse.pattern import (SparsePattern, accum_dtype, fill_dtype,
                              first_flags, pattern_from_perm,
                              trivial_pattern)
from ..sparse.sharded import ShardedCSC, ShardedPattern
from ..sparse.spgemm import ProductPattern
from .segment_sum.ops import segment_sum_sorted


def plan_kernels(rows: torch.Tensor, cols: torch.Tensor, *, M: int, N: int,
                 nzmax: int | None = None) -> SparsePattern:
    """Symbolic phase on the radix planner kernels (B1, B2).

    Counterpart of ``repro.kernels.assembly_ops.plan_pallas``.
    """
    L = rows.shape[0]
    nzmax = L if nzmax is None else nzmax
    if L == 0 or M == 0 or N == 0:
        return trivial_pattern(L, (M, N), nzmax=nzmax, device=rows.device)
    rows = rows.to(torch.int32).contiguous()
    cols = cols.to(torch.int32).contiguous()
    perm = sorted_permutation(rows, cols, M=M, N=N, method="radix")
    return pattern_from_perm(rows, cols, perm, M=M, N=N, nzmax=nzmax)


def fill_fused(pattern: SparsePattern, vals: torch.Tensor, *,
               accum: str | None = None) -> CSC:
    """Fused numeric phase: gather + mask + segment reduce in one kernel.

    Counterpart of ``repro.kernels.assembly_ops.fill_fused``: B3' for
    ``sum``/``mean``, B4 for ``min``/``max``, a scatter for
    ``first``/``last`` (:func:`~.segment_sum.ops
    .gather_segment_reduce_sorted`).  Output dtype follows the shared
    ``fill_dtype`` contract; ``accum=None`` follows the pattern's mode.
    It is ``pattern.assemble``: the length check and the gradient come
    with it.
    """
    return pattern.assemble(vals, accum=accum)


def fill_pallas(pattern: SparsePattern, vals: torch.Tensor, *,
                accum: str | None = None) -> CSC:
    """Numeric phase with the *unfused* sorted-segment sum.

    Counterpart of ``repro.kernels.assembly_ops.fill_pallas``: the
    masked ``vals[perm]`` gather in PyTorch, a prefix sum (B5) and the
    per-segment differences of :func:`~.segment_sum.ops
    .segment_sum_sorted`.  A float32 prefix past 2^24 loses low bits,
    as the reference's does; :func:`fill_fused` sums each segment
    directly.  Non-``sum`` modes go to :func:`fill_fused`.  The ``sum``
    fill records no gradient on the card (B5 is not differentiable):
    take gradients through :func:`fill_fused`.
    """
    accum = pattern.accum if accum is None else accum
    if accum != "sum":
        return fill_fused(pattern, vals, accum=accum)
    pattern.check_vals(vals)
    nzmax = pattern.nzmax
    dtype = fill_dtype(vals)
    acc = accum_dtype(dtype)  # 16-bit floats prefix-sum in float32
    v_s = torch.where(pattern.slot < nzmax, vals[pattern.perm].to(acc),
                      torch.zeros((), dtype=acc, device=vals.device))
    totals = segment_sum_sorted(v_s, first_flags(pattern.slot, nzmax),
                                num_segments=nzmax)
    return pattern._csc(totals.to(dtype))


def fill_sharded_pallas(pattern: ShardedPattern,
                        vals: torch.Tensor) -> ShardedCSC:
    """Numeric phase of a :class:`~repro_torch.sparse.sharded.ShardedPattern`
    on B3'.

    Counterpart of ``repro.kernels.assembly_ops.fill_sharded_pallas``:
    the Phase B replay on values (bucket scatter and the exchange), then
    each row block's reduce on the fused gather + masked segment-sum
    kernel instead of a colliding scatter-add.  The port's
    ``ShardedPattern.assemble`` is that path (one B3' launch over the
    blocks' streams), so this is that call, with its gradient.
    """
    return pattern.assemble(vals)


def assemble_kernels(rows: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, *, M: int, N: int,
                     nzmax: int | None = None) -> CSC:
    """Padded-CSC assembly with every size-L pass in a kernel.

    Counterpart of ``repro.kernels.assembly_ops.assemble_pallas``.
    """
    return fill_fused(plan_kernels(rows, cols, M=M, N=N, nzmax=nzmax), vals)


def multiply_fused(pattern: ProductPattern, data_A: torch.Tensor,
                   data_B: torch.Tensor) -> CSC:
    """Fused SpGEMM numeric phase: both gathers, the multiply and the
    segment sum in one kernel (B6).

    Counterpart of ``repro.kernels.assembly_ops.multiply_fused``, with
    its shape check and message.  It is ``pattern.multiply``: one
    numeric path, which keeps the gradient for both operands.
    """
    if data_A.ndim != 1 or data_A.shape[0] != pattern.a_capacity \
            or data_B.ndim != 1 or data_B.shape[0] != pattern.b_capacity:
        raise ValueError(
            f"operand data shapes {tuple(data_A.shape)}/"
            f"{tuple(data_B.shape)} do not match the planned 1-d "
            f"capacities ({pattern.a_capacity}/{pattern.b_capacity})"
        )
    return pattern.multiply(data_A, data_B)


#: the reference's names (``repro.kernels.plan_pallas``/``assemble_pallas``)
plan_pallas = plan_kernels
assemble_pallas = assemble_kernels
