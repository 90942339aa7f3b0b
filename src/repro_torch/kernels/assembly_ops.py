"""End-to-end kernel-backed sparse assembly (the H100 production path).

Counterparts of ``repro/kernels/assembly_ops.py``'s ``plan_pallas``,
``fill_fused`` and ``assemble_pallas``, renamed because nothing in the
port is Pallas:

  Parts 1-3  radix_sort.radix_sort_pair  (B1 histogram + scan + B2
             placement per digit of at most 8 bits)
  Part 4     prefix over column boundaries (plain PyTorch)
  Numeric    segment_sum.gather_segment_sum_sorted (B3': gather +
             mask + segment sum in one kernel)

On CPU tensors every kernel runs its plain version.
"""
from __future__ import annotations

import torch

from ..core.csc import CSC
from ..sparse.dispatch import sorted_permutation
from ..sparse.pattern import SparsePattern, pattern_from_perm, trivial_pattern


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

    Counterpart of ``repro.kernels.assembly_ops.fill_fused``.  In the
    port :meth:`SparsePattern.assemble` itself runs the fused kernel
    (B3') for ``sum``/``mean``, so this is that fill; ``accum=None``
    follows the pattern's mode.
    """
    return pattern.assemble(vals, accum=accum)


def assemble_kernels(rows: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, *, M: int, N: int,
                     nzmax: int | None = None) -> CSC:
    """Padded-CSC assembly with every size-L pass in a kernel.

    Counterpart of ``repro.kernels.assembly_ops.assemble_pallas``.
    """
    return fill_fused(plan_kernels(rows, cols, M=M, N=N, nzmax=nzmax), vals)
