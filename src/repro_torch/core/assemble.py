"""The paper's index-based sparse assembly, part by part.

Counterpart of ``repro/core/assemble.py``.  The structure follows the
paper's four parts (§2.3):

  Part 1  count rows            -> pessimistic row pointer ``jrS``
  Part 2  counting-sort rank    -> row-ordered traversal order ``rank``
  Part 3  uniqueness            -> per-column dedup; ``irank`` slots
  Part 4  finalize              -> accumulated ``jcS``; rebased ``irank``
  Post    scatter/reduce        -> ``(prS, irS, jcS)``

As in the reference, the serial ``hcol`` last-seen-row cache of Part 3
is a second stable sort over columns followed by adjacent-compare
boundary detection, and the placement loop of Part 2 is a stable sort
here (``repro_torch.kernels.counting_sort`` is the counting-sort
version on the card).  The output CSC has capacity ``nzmax`` (default
``L``) and carries the true ``nnz`` as a 0-d tensor; padding slots
hold ``row == M`` sentinels and zero values.

The one-shot entry points build on :mod:`repro_torch.sparse`, imported
inside the functions: that package imports this one's modules.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .coo import COO
from .csc import CSC


class AssemblyIntermediate(NamedTuple):
    """The paper's intermediate format (Listing 3 / Listing 8).

    ``rank``   : row-ordered traversal permutation (Part 2)
    ``perm``   : full (col,row)-ordered permutation = rank[rank2]
    ``irankP`` : output slot of the k-th element of the *sorted* stream
                 (the parallel version's permuted inverse rank, eq. 3.1)
    ``irank``  : output slot in *original* input order (eq. 2.2-2.3)
    ``jcS``    : accumulated column pointer, length N+1
    ``nnz``    : number of structural nonzeros (0-d)
    """

    rank: torch.Tensor
    perm: torch.Tensor
    irankP: torch.Tensor
    irank: torch.Tensor
    jcS: torch.Tensor
    nnz: torch.Tensor


def _argsort_stable(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices.to(torch.int32)


def _exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0)]).to(torch.int32)


# -- Part 1: count rows (Listing 4 / Listing 9) -----------------------------
def part1_count_rows(rows: torch.Tensor, M: int) -> torch.Tensor:
    """Pessimistic accumulated row counter ``jrS`` (length M+2).

    ``jrS[r]`` = number of inputs with row < r; the extra bin M+1
    absorbs padding sentinels (row == M).  Collisions are ignored: an
    upper bound, exactly as in the paper.
    """
    hist = torch.bincount(rows.long(), minlength=M + 1)  # bin M = padding
    return _exclusive_cumsum(hist)


# -- Part 2: build rank array (Listing 5 / Listing 10) ----------------------
def part2_rank(rows: torch.Tensor, M: int) -> torch.Tensor:
    """Stable counting-sort permutation over row keys: ``rows[rank]`` is
    non-decreasing and equal keys keep input order."""
    del M  # bins are implicit in the stable sort
    return _argsort_stable(rows)


def counting_sort_positions(keys: torch.Tensor,
                            jr: torch.Tensor) -> torch.Tensor:
    """Distribution-counting placement (the paper's Listing 5 algebra).

    ``position[i] = jr[keys[i]] + prior_equal(i)``: the identity the
    counting-sort placement kernel (B11) must meet, written with a
    stable sort (``inv`` is every element's landing position).
    """
    order = torch.sort(keys, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=keys.device)
    base = jr.long()[keys.long()]
    prior_equal = inv - base
    return (base + prior_equal).to(jr.dtype)  # == inv, by construction


# -- Part 3: uniqueness (Listing 6 / Listing 11) ----------------------------
def part3_unique(rows: torch.Tensor, cols: torch.Tensor, rank: torch.Tensor,
                 M: int, N: int):
    """Detect unique (row, col) pairs and build per-column counts.

    A second stable sort by *column* over the row-ordered stream orders
    the data by (col, row) with duplicates adjacent; boundary flags mark
    first occurrences.  Returns ``(perm, first, jc_counts, r_s, c_s,
    valid)``.
    """
    rank2 = _argsort_stable(cols[rank])
    perm = rank[rank2]
    r_s = rows[perm]
    c_s = cols[perm]
    valid = r_s < M
    first = torch.cat([
        torch.ones(1, dtype=torch.bool, device=rows.device),
        (c_s[1:] != c_s[:-1]) | (r_s[1:] != r_s[:-1]),
    ]) & valid
    jc_counts = torch.bincount(torch.where(first, c_s, N).long(),
                               minlength=N + 1)[:N].to(torch.int32)
    return perm, first, jc_counts, r_s, c_s, valid


# -- Part 4: finalize intermediate format (Listing 7 / Listing 11 tail) -----
def part4_finalize(first: torch.Tensor, jc_counts: torch.Tensor):
    """Accumulate the column pointer and rebase slots: ``(jcS, irankP,
    nnz)``.  The sorted-stream slot is the inclusive prefix sum of the
    first-occurrence flags minus one; the rebasing by column starts is
    implicit because the stream is column-ordered."""
    jcS = _exclusive_cumsum(jc_counts)
    irankP = (torch.cumsum(first.to(torch.int32), 0) - 1).to(torch.int32)
    return jcS, irankP, jcS[-1].clone()


# -- Post-processing (Listing 14 / Listing 17) ------------------------------
def postprocess(vals: torch.Tensor, r_s: torch.Tensor, irankP: torch.Tensor,
                first: torch.Tensor, valid: torch.Tensor, perm: torch.Tensor,
                nzmax: int, M: int):
    """Scatter rows / segment-reduce values into ``(prS, irS)``.

    Duplicates are adjacent in the sorted stream, so the paper's
    colliding scatter-add is a segment sum; slots past ``nzmax`` drop.
    """
    v_s = torch.where(valid, vals[perm], torch.zeros((), dtype=vals.dtype))
    slot = torch.where(valid & (irankP < nzmax), irankP, nzmax).long()
    prS = vals.new_zeros(nzmax + 1).index_add_(0, slot, v_s)[:nzmax]
    irS = torch.full((nzmax + 1,), M, dtype=torch.int32, device=vals.device)
    irS[torch.where(first, slot, nzmax)] = r_s.to(torch.int32)
    return prS, irS[:nzmax]


# -- Public entry points ----------------------------------------------------
def assemble_arrays(rows, cols, vals, *, M: int, N: int,
                    nzmax: int | None = None) -> CSC:
    """Assemble zero-offset COO tensors into a padded CSC (4-part path):
    ``plan(..., method="jnp")`` and the numeric fill."""
    from ..sparse.pattern import plan

    nzmax = rows.shape[0] if nzmax is None else nzmax
    return plan(rows, cols, (M, N), nzmax=nzmax, method="jnp").assemble(vals)


def assemble_fused(rows, cols, vals, *, M: int, N: int,
                   nzmax: int | None = None) -> CSC:
    """One stable sort on the fused int64 key ``col * (M+1) + row``
    instead of two passes (``method="fused"``)."""
    from ..sparse.pattern import plan

    nzmax = rows.shape[0] if nzmax is None else nzmax
    return plan(rows, cols, (M, N), nzmax=nzmax,
                method="fused").assemble(vals)


def assemble(coo: COO, *, nzmax: int | None = None,
             fused: bool | None = None, method: str | None = None) -> CSC:
    """One-shot assembly with backend dispatch.

    ``method`` is the single dispatch point (``"jnp" | "fused" |
    "pallas" | "radix"``, see :mod:`repro_torch.sparse.dispatch`; with
    neither argument the default of the COO's device applies); the
    boolean ``fused=`` flag is a deprecated alias.  As in the reference,
    ``"pallas"`` here is the kernel path of
    :func:`repro_torch.kernels.assembly_ops.assemble_kernels` (radix
    plan + fused fill), not the counting sort that
    ``plan(method="pallas")`` runs.
    """
    from .compat import resolve_method_arg

    method = resolve_method_arg(fused, method, api="assemble",
                                device=coo.rows.device, stacklevel=3)
    if method == "jnp":
        fn = assemble_arrays
    elif method == "fused":
        fn = assemble_fused
    elif method == "pallas":
        from ..kernels.assembly_ops import assemble_kernels

        fn = assemble_kernels
    else:
        from ..sparse.pattern import plan

        return plan(coo.rows, coo.cols, coo.shape, nzmax=nzmax,
                    method=method).assemble(coo.vals)
    return fn(coo.rows, coo.cols, coo.vals, M=coo.M, N=coo.N, nzmax=nzmax)


def assembly_intermediates(rows, cols, *, M: int,
                           N: int) -> AssemblyIntermediate:
    """The paper's intermediate arrays (for tests and benchmarks).

    ``irank`` (original-order slots, eq. 2.2) is recovered from the
    sorted-stream slots: ``irank[perm[k]] = irankP[k]``.
    """
    rows = rows.to(torch.int32)
    cols = cols.to(torch.int32)
    rank = part2_rank(rows, M)
    perm, first, jc_counts, _, _, _ = part3_unique(rows, cols, rank, M, N)
    jcS, irankP, nnz = part4_finalize(first, jc_counts)
    irank = torch.empty_like(irankP)
    irank[perm] = irankP
    return AssemblyIntermediate(rank=rank, perm=perm, irankP=irankP,
                                irank=irank, jcS=jcS, nnz=nnz)
