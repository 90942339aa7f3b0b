"""repro_torch.sparse.ops: one operator surface for every registered format.

Counterpart of ``repro/sparse/ops.py``.  The operators dispatch per
registered format through the registry that
:func:`repro_torch.sparse.formats.convert` uses, so a consumer writes
``ops.matmul(A, x)`` for any ``A`` and a new format joins by calling
:func:`register_op`.

Every operator is differentiable with autograd: CSC, CSR and COO spmv
are gathers and scatter-adds; SymCSC and BSR spmv are
``torch.autograd.Function``s whose backwards are the reference's
``custom_vjp``s; a sparse second operand takes the two-phase SpGEMM of
:mod:`repro_torch.sparse.spgemm`.  On the card SymCSC spmv runs B9, BSR
spmv B10 and the SpGEMM refill B6; CSC spmv stays ``core/csc.py``'s
gather and scatter-add, as in the reference, which runs no kernel
there.

    >>> import torch
    >>> from repro_torch.sparse import fsparse, ops
    >>> A = fsparse([1, 2, 2, 1], [1, 1, 2, 1], [1.0, 2.0, 3.0, 4.0],
    ...             (2, 2), device="cpu")
    >>> ops.to_dense(A)
    tensor([[5., 0.],
            [2., 3.]])
    >>> ops.matmul(A, torch.ones(2))
    tensor([5., 5.])
    >>> ops.to_dense(ops.matmul(A, A))
    tensor([[25.,  0.],
            [16.,  9.]])
    >>> type(ops.transpose(A)).__name__
    'CSR'

The ``"sharded"`` format (``ShardedCSC``) runs its block-row SpMV
(``core/csc.py``'s on every row block); its other operators go through
the COO hub.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..core.coo import COO
from ..core.csc import CSC, scatter_add, slot_columns
from ..core.csc import spmv as _csc_spmv
from .formats import BSR, CSR, SymCSC, convert, format_of
from .pattern import fill_dtype

__all__ = [
    "add",
    "diagonal",
    "matmul",
    "register_op",
    "scale",
    "scatter_rows",
    "spmv_impl",
    "to_dense",
    "transpose",
]

_OP_IMPLS: Dict[Tuple[str, str], Callable] = {}


def register_op(op: str, fmt: str, fn: Callable) -> None:
    """Register ``fn`` as the ``op`` implementation for format ``fmt``."""
    _OP_IMPLS[(op, fmt)] = fn


def _dispatch(op: str, A, *, hub: str | None = None):
    """Implementation for ``(op, format_of(A))``, optionally via a hub.

    When no direct implementation exists and ``hub`` is given, ``A`` is
    converted through the format registry and the hub's implementation
    is used.
    """
    fmt = format_of(A)
    fn = _OP_IMPLS.get((op, fmt))
    if fn is not None:
        return fn, A
    if hub is not None and (op, hub) in _OP_IMPLS:
        return _OP_IMPLS[(op, hub)], convert(A, hub)
    raise TypeError(
        f"no {op!r} implementation for format {fmt!r} "
        f"(registered: {sorted(k for k in _OP_IMPLS if k[0] == op)})"
    )


def _zero(dtype, device) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# matmul: spmv / spmm
# ---------------------------------------------------------------------------
def _coo_spmv(A: COO, x: torch.Tensor) -> torch.Tensor:
    valid = A.rows < A.M
    contrib = A.vals * x[torch.where(valid, A.cols, 0).long()]
    return scatter_add(A.M, A.rows, contrib, valid)


def _sharded_spmv(A, x: torch.Tensor) -> torch.Tensor:
    return A.spmv(x)


def _csr_spmv(A: CSR, x: torch.Tensor) -> torch.Tensor:
    rows = slot_columns(A.indptr, A.nzmax)  # row of each slot
    valid = (A.indices < A.N) & (rows < A.M)
    contrib = A.data * x[torch.where(valid, A.indices, 0).long()]
    return scatter_add(A.M, rows, contrib, valid)


class _SpmvSym(torch.autograd.Function):
    """Fused both-triangles symmetric SpMV with the reference's sparse
    backward (``_spmv_sym_vjp``).

    Symmetric SpMV is self-transpose, so ``dL/dx = A g`` reuses the same
    forward (B9 on the card); ``dL/ddata[s] = x[col_s] g[row_s] +
    x[row_s] g[col_s]`` and ``dL/ddiag = x g``: O(nzmax) gathers through
    the halved structure.
    """

    @staticmethod
    def forward(ctx, diag, data, indices, indptr, x, M, longest):
        from ..kernels.spmv_sym.ops import spmv_sym

        ctx.save_for_backward(diag, data, indices, indptr, x)
        ctx.M, ctx.longest = M, longest
        return spmv_sym(diag, data, indices, indptr, x, longest=longest)

    @staticmethod
    def backward(ctx, g):
        from ..kernels.spmv_sym.ops import spmv_sym

        diag, data, indices, indptr, x = ctx.saved_tensors
        M = ctx.M
        g_x = spmv_sym(diag, data, indices, indptr, g,
                       longest=ctx.longest).to(x.dtype)
        g_diag = (x * g).to(diag.dtype)
        cols = slot_columns(indptr, data.shape[-1])
        valid = indices < M
        r = torch.where(valid, indices, 0).long()
        c = torch.where(valid, cols.clamp(0, max(M - 1, 0)), 0).long()
        g_data = torch.where(valid, x[c] * g[r] + x[r] * g[c],
                             _zero(data.dtype, g.device)).to(data.dtype)
        return g_diag, g_data, None, None, g_x, None, None


def _symcsc_spmv(A: SymCSC, x: torch.Tensor) -> torch.Tensor:
    return _SpmvSym.apply(A.diag, A.data, A.indices, A.indptr, x, A.M,
                          A.longest)


class _SpmvBsr(torch.autograd.Function):
    """Blocked SpMV with the reference's sparse backward
    (``_spmv_bsr_vjp``): ``dL/dx`` scatter-adds ``data[k].T @
    g_block[row_k]`` into block columns and ``dL/ddata[k] =
    g_block[row_k] (x) x_block[col_k]``, both O(nbmax b^2)."""

    @staticmethod
    def forward(ctx, data, indices, indptr, x, shape, block):
        from ..kernels.spmv_sym.ops import spmv_bsr

        ctx.save_for_backward(data, indices, indptr, x)
        ctx.shape, ctx.block = shape, block
        return spmv_bsr(data, indices, indptr, x, shape=shape, block=block)

    @staticmethod
    def backward(ctx, g):
        data, indices, indptr, x = ctx.saved_tensors
        M, N = int(ctx.shape[0]), int(ctx.shape[1])
        b = int(ctx.block)
        Mb, Nb = M // b, N // b
        bcols = slot_columns(indptr, data.shape[0])
        valid = indices < Mb
        br = torch.where(valid, indices, 0).long()
        bc = torch.where(valid, bcols.clamp(0, max(Nb - 1, 0)), 0).long()
        gb = g.reshape(Mb, b)[br]                              # [nbmax, b]
        xb = x.reshape(Nb, b)[bc]                              # [nbmax, b]
        g_data = torch.where(valid[:, None, None],
                             torch.einsum("ki,kj->kij", gb, xb), 0) \
            .to(data.dtype)
        contrib = torch.where(valid[:, None],
                              torch.einsum("kij,ki->kj", data.to(gb.dtype),
                                           gb), 0)
        g_x = scatter_add(Nb, bc, contrib, valid, scratch=1)
        return g_data, None, None, g_x.reshape(N).to(x.dtype), None, None


def _bsr_spmv(A: BSR, x: torch.Tensor) -> torch.Tensor:
    return _SpmvBsr.apply(A.data, A.indices, A.indptr, x, A.shape, A.block)


def _spgemm(A, B) -> CSC:
    """Sparse x sparse product through the two-phase SpGEMM subsystem:
    both operands converted to the CSC hub, the symbolic phase served
    from the product-plan LRU, the O(flops) refill on B6."""
    from .spgemm import cached_product_plan

    Ac = convert(A, "csc")
    Bc = convert(B, "csc")
    return cached_product_plan(Ac, Bc).multiply(Ac.data, Bc.data)


def spmv_impl(A):
    """Resolve the per-format spmv implementation for ``A`` once:
    ``(fn, A_resolved)``, where ``fn(A_resolved, x)`` is what
    :func:`matmul` runs for a dense vector ``x``."""
    return _dispatch("spmv", A, hub="csc")


def matmul(A, x):
    """``A @ x`` (spmv), ``A @ X`` (spmm), or sparse ``A @ B`` (SpGEMM).

    Dense operands dispatch per registered format; a 2-D ``X`` runs the
    spmv column by column (what the reference's ``vmap`` computes).  A
    sparse second operand takes the two-phase SpGEMM path and returns a
    padded :class:`CSC`, differentiable w.r.t. both operands' data.
    """
    try:
        fmt = format_of(x)
    except TypeError:
        fmt = None  # not a registered sparse format: dense spmv/spmm
    if fmt is not None:
        # outside the try: a TypeError raised inside the SpGEMM path
        # must surface, not fall through to the dense path
        return _spgemm(A, x)
    x = torch.as_tensor(x)
    fn, A = _dispatch("spmv", A, hub="csc")
    if x.ndim == 1:
        return fn(A, x)
    if x.ndim == 2:
        return torch.stack([fn(A, x[:, j]) for j in range(x.shape[1])],
                           dim=1)
    raise ValueError(f"matmul expects a vector or matrix, got ndim={x.ndim}")


# ---------------------------------------------------------------------------
# transpose: CSC<->CSR are free reinterpretations of the same arrays
# ---------------------------------------------------------------------------
def _csc_transpose(A: CSC) -> CSR:
    # Aᵀ's rows are A's columns: the column pointer is the transposed row
    # pointer and the row indices are the transposed column indices
    # (sentinel M == the CSR col sentinel for shape (N, M))
    return CSR(data=A.data, indices=A.indices, indptr=A.indptr,
               nnz=A.nnz, shape=(A.N, A.M))


def _csr_transpose(A: CSR) -> CSC:
    return CSC(data=A.data, indices=A.indices, indptr=A.indptr,
               nnz=A.nnz, shape=(A.N, A.M))


def _coo_transpose(A: COO) -> COO:
    valid = A.rows < A.M
    return COO(
        rows=torch.where(valid, A.cols, A.N).to(torch.int32),
        cols=torch.where(valid, A.rows, 0).to(torch.int32),
        vals=A.vals,
        shape=(A.N, A.M),
    )


def _symcsc_transpose(A: SymCSC) -> SymCSC:
    # A == Aᵀ by construction: the transpose is the same object
    return A


def _bsr_transpose(A: BSR) -> BSR:
    """Direct BSR transpose: one stable block sort + per-tile swap.

    The stored block stream is (block-col, block-row) lexicographic, so
    one stable argsort by block row yields the transposed order; each
    dense tile transposes in place.  Zeroed invalid tails make the
    double transpose bit-identical.
    """
    b, Mb, Nb = A.block, A.Mb, A.Nb
    bcols = slot_columns(A.indptr, A.nbmax)
    valid = A.indices < Mb
    order = torch.argsort(A.indices, stable=True)   # sentinels sink last
    counts = torch.bincount(torch.where(valid, A.indices, Mb).long(),
                            minlength=Mb + 1)[:Mb]
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]) \
        .to(torch.int32)
    data = torch.where(valid[:, None, None], A.data.transpose(1, 2),
                       _zero(A.data.dtype, A.data.device))[order]
    indices = torch.where(valid, bcols.clamp(0, max(Nb - 1, 0)), Nb)[order] \
        .to(torch.int32)
    return BSR(data=data, indices=indices, indptr=indptr, nnz=A.nnz,
               shape=(A.N, A.M), block=b)


def transpose(A):
    """``Aᵀ``.  CSC <-> CSR is a zero-cost array reinterpretation; COO
    swaps its index vectors; SymCSC returns the same object; BSR
    resorts its block stream directly; other formats go through the
    COO hub."""
    fn, A = _dispatch("transpose", A, hub="coo")
    return fn(A)


# ---------------------------------------------------------------------------
# add / scale / diagonal / to_dense
# ---------------------------------------------------------------------------
def add(A, B):
    """``A + B`` for any two registered formats of equal shape.

    Concatenates the COO triplet streams and reassembles into ``A``'s
    format: one plan over L_A + L_B triplets, overlapping structure
    merging by the duplicate-summing rule.  The fill follows
    :func:`~repro_torch.sparse.pattern.fill_dtype` on the promoted
    operand dtype.
    """
    if tuple(A.shape) != tuple(B.shape):
        raise ValueError(f"shape mismatch: {A.shape} vs {B.shape}")
    ca, cb = convert(A, "coo"), convert(B, "coo")
    dtype = fill_dtype(torch.promote_types(ca.vals.dtype, cb.vals.dtype))
    out = COO(
        rows=torch.cat([ca.rows, cb.rows]),
        cols=torch.cat([ca.cols, cb.cols]),
        vals=torch.cat([ca.vals.to(dtype), cb.vals.to(dtype)]),
        shape=tuple(A.shape),
    )
    fmt = format_of(A)
    if fmt == "coo":
        return out
    kwargs = {"mesh": A.mesh} if fmt == "sharded" else {}
    if fmt == "bsr":
        kwargs = {"block": A.block}
    return convert(out, fmt, **kwargs)


def scale(A, alpha):
    """``alpha * A``: elementwise scale of the stored values, format and
    structure preserved.  SymCSC scales both of its numeric streams."""
    if isinstance(A, SymCSC):
        return dataclasses.replace(A, diag=A.diag * alpha,
                                   data=A.data * alpha)
    field = "vals" if isinstance(A, COO) else "data"
    return dataclasses.replace(A, **{field: getattr(A, field) * alpha})


def _symcsc_diagonal(A: SymCSC) -> torch.Tensor:
    # the dense diagonal is stored outright
    return A.diag


def _coo_diagonal(A: COO) -> torch.Tensor:
    k = min(A.M, A.N)
    valid = (A.rows < A.M) & (A.rows == A.cols)
    return scatter_add(k, A.rows, A.vals, valid, scratch=1)


def diagonal(A) -> torch.Tensor:
    """Main diagonal as a dense ``min(M, N)`` vector (duplicates sum)."""
    fn, A = _dispatch("diagonal", A, hub="coo")
    return fn(A)


def to_dense(A) -> torch.Tensor:
    """Dense materialization: the universal (expensive) escape hatch."""
    return A.to_dense()


# ---------------------------------------------------------------------------
# scatter_rows: the shared dispatch/combine primitive
# ---------------------------------------------------------------------------
class _ScatterRows(torch.autograd.Function):
    """``out[slot[k]] = rows[k]`` with the reference's gather backward:
    ``g_rows[k] = g[slot[k]]`` for kept slots, 0 for dropped ones."""

    @staticmethod
    def forward(ctx, slot, rows, num_slots):
        ctx.save_for_backward(slot)
        ctx.num_slots = num_slots
        out = rows.new_zeros((num_slots + 1,) + tuple(rows.shape[1:]))
        keep = (slot >= 0) & (slot < num_slots)
        out[torch.where(keep, slot, num_slots).long()] = rows
        return out[:num_slots]

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        n = ctx.num_slots
        keep = slot < n
        keep = keep.reshape(keep.shape + (1,) * (g.ndim - 1))
        if n == 0:
            return None, g.new_zeros(slot.shape + tuple(g.shape[1:])), None
        g_rows = torch.where(keep, g[slot.clamp(0, n - 1).long()],
                             _zero(g.dtype, g.device))
        return None, g_rows, None


def scatter_rows(slot: torch.Tensor, rows: torch.Tensor, *,
                 num_slots: int) -> torch.Tensor:
    """Collision-free row scatter with a gather backward.

    ``out[slot[k]] = rows[k]`` for ``slot[k] < num_slots`` (out-of-range
    slots, capacity overflow sentinels, are dropped); slots must be
    unique.  The backward is the masked gather ``g_rows[k] =
    g[slot[k]]``: the primitive behind MoE dispatch/combine and the
    embedding-gradient assembly.
    """
    return _ScatterRows.apply(slot, rows, num_slots)


# ---------------------------------------------------------------------------
# Built-in registrations
# ---------------------------------------------------------------------------
register_op("spmv", "csc", _csc_spmv)
register_op("spmv", "csr", _csr_spmv)
register_op("spmv", "coo", _coo_spmv)
register_op("spmv", "sharded", _sharded_spmv)
register_op("spmv", "symcsc", _symcsc_spmv)
register_op("spmv", "bsr", _bsr_spmv)
register_op("transpose", "csc", _csc_transpose)
register_op("transpose", "csr", _csr_transpose)
register_op("transpose", "coo", _coo_transpose)
register_op("transpose", "symcsc", _symcsc_transpose)
register_op("transpose", "bsr", _bsr_transpose)
register_op("diagonal", "coo", _coo_diagonal)
register_op("diagonal", "symcsc", _symcsc_diagonal)
