"""Two-phase sparse x sparse products (SpGEMM) on the plan/fill core.

Counterpart of ``repro/sparse/spgemm.py``.  A sparse product ``C = A @
B`` is an assembly problem: expanding every stored ``B(k, j)`` against
the stored column ``A(:, k)`` yields the raw triplet stream ``(i, j,
A(i, k) * B(k, j))``, and summing its duplicates is the Matlab
``sparse`` contract the plan/fill core implements.

``product_plan(A, B)`` runs once per structure pair:

  1. per-entry expansion counts off ``indptr`` gathers (host numpy over
     the structure arrays, as in the reference),
  2. a static expansion capacity ``flops_max`` (the flop count,
     optionally padded),
  3. the port's :func:`~repro_torch.sparse.pattern.plan` over the
     expanded ``(i, j)`` stream on the operands' device (on the card
     the radix planner's kernels), compacted to the true ``nnz``.

:meth:`ProductPattern.multiply` is then the O(flops) numeric phase: on
the card one kernel (B6) gathers both operands, multiplies and sums
each output slot's run; differentiable w.r.t. both operands through a
``torch.autograd.Function`` whose backward is the reference's
``_multiply_vjp_bwd``.

    >>> import numpy as np, torch
    >>> from repro_torch.sparse import plan, product_plan
    >>> pa = plan(torch.tensor([0, 0, 1]), torch.tensor([0, 1, 1]), (2, 2))
    >>> pb = plan(torch.tensor([0, 1, 1]), torch.tensor([0, 0, 1]), (2, 2))
    >>> A = pa.assemble(torch.tensor([1.0, 2.0, 3.0]))
    >>> B = pb.assemble(torch.tensor([4.0, 5.0, 6.0]))
    >>> pp = product_plan(pa, pb)
    >>> pp.flops, int(pp.pattern.nnz)   # 5 partial products, 4 cells
    (5, 4)
    >>> pp.multiply(A.data, B.data).to_dense()
    tensor([[14., 12.],
            [15., 18.]])
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..core.csc import CSC
from .formats import CSR
from .lru import LRUCache
from .pattern import SparsePattern, accum_dtype, plan, trivial_pattern

__all__ = [
    "ProductPattern",
    "product_plan",
    "product_lookup",
    "cached_product_plan",
    "product_cache_clear",
    "product_cache_info",
    "retire_structure",
    "product_pattern_from_arrays",
]


@dataclasses.dataclass(frozen=True)
class ProductPattern:
    """Symbolic SpGEMM plan: C's assembly pattern + expansion maps.

    ``sa``/``sb`` are aligned with the *sorted* product stream (the
    order of ``pattern.slot``): element k of the sorted stream is
    ``data_A[sa[k]] * data_B[sb[k]]`` and lands in ``pattern.slot[k]``.
    Dropped expansion entries (capacity padding) carry the plan's
    ``slot == nzmax`` sentinel and ``sa == sb == 0`` placeholders.
    ``epoch`` is the sum of the operand plans' ``epoch`` fields at
    planning time.
    """

    sa: torch.Tensor         # int32[flops_max]; stored slot in A.data
    sb: torch.Tensor         # int32[flops_max]; stored slot in B.data
    pattern: SparsePattern   # C's plan over the expanded (i, j) stream
    a_capacity: int
    b_capacity: int
    epoch: int = 0

    @property
    def flops(self) -> int:
        """Static expansion capacity (the classic SpGEMM flop count)."""
        return int(self.sa.shape[-1])

    @property
    def shape(self) -> tuple[int, int]:
        return self.pattern.shape

    @property
    def nzmax(self) -> int:
        return self.pattern.nzmax

    def multiply(self, data_A: torch.Tensor, data_B: torch.Tensor) -> CSC:
        """O(flops) numeric refill: gather-multiply-reduce, no sort.

        ``data_A``/``data_B`` are the ``data`` vectors of CSC matrices
        sharing the structures this plan was built from (padded tails
        included: their zeros never reach a kept slot).  The result is C
        as a padded :class:`CSC`, differentiable w.r.t. both operands.
        """
        data_A = torch.as_tensor(data_A)
        data_B = torch.as_tensor(data_B)
        if data_A.ndim != 1 or data_A.shape[0] != self.a_capacity:
            raise ValueError(
                f"data_A has shape {tuple(data_A.shape)} but this product "
                f"was planned for an A with nzmax={self.a_capacity}"
            )
        if data_B.ndim != 1 or data_B.shape[0] != self.b_capacity:
            raise ValueError(
                f"data_B has shape {tuple(data_B.shape)} but this product "
                f"was planned for a B with nzmax={self.b_capacity}"
            )
        data = _Multiply.apply(data_A, data_B, self.sa, self.sb,
                               self.pattern.slot, self.nzmax)
        return CSC(data=data, indices=self.pattern.indices,
                   indptr=self.pattern.indptr, nnz=self.pattern.nnz,
                   shape=self.pattern.shape)


class _Multiply(torch.autograd.Function):
    """Differentiable numeric phase.

    ``data[s] = sum_k va[sa[k]] * vb[sb[k]]`` over the kept expansion
    entries landing in slot ``s`` (B6 on the card, its plain version on
    the CPU), so the backward w.r.t. each operand is the product rule
    through the stored maps (the reference's ``_multiply_vjp_bwd``):

        g_va[a] = sum_{k: sa[k]=a} g[slot[k]] * vb[sb[k]]
        g_vb[b] = sum_{k: sb[k]=b} g[slot[k]] * va[sa[k]]
    """

    @staticmethod
    def forward(ctx, va, vb, sa, sb, slot, nzmax):
        # lazy: the kernel family's ops module imports sparse.pattern
        from ..kernels.segment_sum.ops import gather2_segment_sum_sorted

        ctx.save_for_backward(sa, sb, slot, va, vb)
        ctx.nzmax = nzmax
        return gather2_segment_sum_sorted(va, vb, sa, sb, slot,
                                          num_segments=nzmax)

    @staticmethod
    def backward(ctx, g):
        sa, sb, slot, va, vb = ctx.saved_tensors
        nzmax = ctx.nzmax
        acc = accum_dtype(g.dtype)
        if nzmax == 0:
            g_s = torch.zeros(slot.shape, dtype=acc, device=g.device)
        else:
            g_s = torch.where(slot < nzmax,
                              g[slot.clamp(0, nzmax - 1).long()].to(acc),
                              torch.zeros((), dtype=acc, device=g.device))
        g_va = g_vb = None
        if ctx.needs_input_grad[0]:
            g_va = torch.zeros(va.shape[0], dtype=acc, device=g.device) \
                .index_add_(0, sa, g_s * vb.to(acc)[sb]).to(va.dtype)
        if ctx.needs_input_grad[1]:
            g_vb = torch.zeros(vb.shape[0], dtype=acc, device=g.device) \
                .index_add_(0, sb, g_s * va.to(acc)[sa]).to(vb.dtype)
        return g_va, g_vb, None, None, None, None


def _csc_structure(S) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Host (indices, indptr, nnz, nzmax) of a plan or CSC matrix.

    Accepts anything column-compressed: a :class:`SparsePattern` or a
    :class:`CSC`.  A row-compressed operand (CSR) would pass an
    attribute check and silently produce a wrong product, so the
    compression axis is validated against the shape.
    """
    for f in ("indices", "indptr"):
        if not hasattr(S, f):
            raise TypeError(
                f"product_plan operands must be column-compressed "
                f"(SparsePattern or CSC) — {type(S).__name__} has no "
                f"{f!r}; convert(A, 'csc') first"
            )
    if isinstance(S, CSR):
        # a square CSR would pass the indptr-length check below and
        # silently compute the product of the transpose
        raise TypeError(
            "product_plan operands must be column-compressed; got a "
            "CSR — convert(A, 'csc') first"
        )
    indptr = S.indptr.cpu().numpy()
    if indptr.shape[0] != int(S.shape[1]) + 1:
        raise TypeError(
            f"product_plan operands must be column-compressed, but this "
            f"{type(S).__name__} of shape {tuple(S.shape)} has an "
            f"indptr of length {indptr.shape[0]} (expected N+1 = "
            f"{int(S.shape[1]) + 1}); convert(A, 'csc') first"
        )
    indices = S.indices.cpu().numpy()
    return indices, indptr, int(S.nnz), int(indices.shape[0])


def _expand(ir_A, jc_A, ir_B, jc_B, nnz_B: int, M: int, flops_max):
    """The symbolic expansion on the host: every stored ``B(k, j)``
    against the stored column ``A(:, k)``.  Returns ``(rows_C, cols_C,
    sa, sb, flops, flops_max)`` in expansion order, padded to
    ``flops_max`` with ``row == M`` sentinels."""
    b_slots = np.arange(nnz_B, dtype=np.int64)
    k_of_b = ir_B[:nnz_B].astype(np.int64)          # B's row == A's col
    j_of_b = np.searchsorted(jc_B, b_slots, side="right") - 1
    col_start = jc_A[:-1].astype(np.int64)[k_of_b]
    col_len = (jc_A[1:] - jc_A[:-1]).astype(np.int64)[k_of_b]
    offsets = np.concatenate([[0], np.cumsum(col_len)])
    flops = int(offsets[-1])
    if flops_max is None:
        flops_max = flops
    elif flops_max < flops:
        raise ValueError(
            f"flops_max={flops_max} cannot hold the {flops} partial "
            "products of this structure pair"
        )
    t_of_e = np.repeat(b_slots, col_len)            # B slot per product
    r_in_col = np.arange(flops, dtype=np.int64) - offsets[t_of_e]
    sa_e = col_start[t_of_e] + r_in_col             # A slot per product
    rows_C = np.full(flops_max, M, np.int32)        # padding: sentinel
    cols_C = np.zeros(flops_max, np.int32)
    rows_C[:flops] = ir_A[sa_e]
    cols_C[:flops] = j_of_b[t_of_e]
    sa = np.zeros(flops_max, np.int32)
    sb = np.zeros(flops_max, np.int32)
    sa[:flops] = sa_e
    sb[:flops] = t_of_e
    return rows_C, cols_C, sa, sb, flops, flops_max


def product_plan(A, B, *, method: str | None = None,
                 nzmax: int | None = None,
                 flops_max: int | None = None) -> ProductPattern:
    """Symbolic SpGEMM phase: expansion maps + C's assembly plan, once.

    ``A`` (M x K) and ``B`` (K x N) are column-compressed structures
    (:class:`SparsePattern` or :class:`CSC`; values are ignored).  The
    expansion runs on the host; the port's :func:`plan` over the
    expanded stream (any registered ``method=``; ``None`` is the
    device's default) runs on A's device.  ``flops_max`` fixes the
    expansion capacity (default: the exact flop count; larger values
    pad with dropped entries); ``nzmax`` is C's storage capacity
    (default: the true structural nnz, read on the host after planning
    and applied by slicing, no re-plan).
    """
    ir_A, jc_A, _, cap_A = _csc_structure(A)
    ir_B, jc_B, nnz_B, cap_B = _csc_structure(B)
    M, K = int(A.shape[0]), int(A.shape[1])
    Kb, N = int(B.shape[0]), int(B.shape[1])
    if K != Kb:
        raise ValueError(
            f"inner dimensions must agree: A is {tuple(A.shape)}, B is "
            f"{tuple(B.shape)}"
        )
    dev = A.indices.device
    rows_C, cols_C, sa, sb, flops, flops_max = _expand(
        ir_A, jc_A, ir_B, jc_B, nnz_B, M, flops_max)
    if flops_max == 0 or M == 0 or N == 0:
        pat = trivial_pattern(flops_max, (M, N),
                              nzmax=0 if nzmax is None else nzmax,
                              device=dev)
    else:
        pat = plan(torch.from_numpy(rows_C).to(dev),
                   torch.from_numpy(cols_C).to(dev), (M, N),
                   nzmax=flops_max if nzmax is None else nzmax,
                   method=method)
        if nzmax is None:
            # compact C's capacity to the true structural nnz: kept slots
            # are already 0..nnz-1, so only the drop sentinel moves
            nnz = int(pat.nnz)
            pat = dataclasses.replace(pat, slot=pat.slot.clamp(max=nnz),
                                      indices=pat.indices[:nnz])
    # re-order the source maps into the sorted product stream once, so
    # the numeric phase needs no permutation gather of its own
    perm = pat.perm.long()
    return ProductPattern(
        sa=torch.from_numpy(sa).to(dev)[perm],
        sb=torch.from_numpy(sb).to(dev)[perm],
        pattern=pat, a_capacity=cap_A, b_capacity=cap_B,
        epoch=int(getattr(A, "epoch", 0)) + int(getattr(B, "epoch", 0)),
    )


# ---------------------------------------------------------------------------
# Product-plan cache (the sparse2 spirit for repeated products)
# ---------------------------------------------------------------------------
#: thread-safe SpGEMM plan LRU (the shared core of sparse/lru.py).
#: Capacity is read from REPRO_PRODUCT_CACHE_SIZE at import; resize at
#: runtime with ``_PRODUCT_CACHE.resize(n)``.
_PRODUCT_CACHE = LRUCache(16, name="product-plan",
                          env="REPRO_PRODUCT_CACHE_SIZE")


def _structure_key(S) -> tuple:
    """Structure-identity key of one column-compressed operand.

    As the reference's: raw bytes alone are not an identity, so shapes
    and dtypes take part.  The port's own point, as in the ``sparse2``
    key: the device takes part too (a CPU plan and a CUDA plan of one
    structure are different resident plans).
    """
    indices = S.indices.cpu().numpy()
    indptr = S.indptr.cpu().numpy()
    return (
        indices.tobytes(), indptr.tobytes(),
        indices.shape, indices.dtype.str, tuple(S.shape),
        str(S.indices.device),
    )


#: operand structure keys retired by delta updates; dependent cached
#: products are dropped lazily, at the next lookup
_RETIRED_STRUCTURES: set = set()
_RETIRED_LOCK = threading.Lock()


def retire_structure(structure_key: tuple) -> None:
    """Mark one operand structure (a :func:`_structure_key` token) stale:
    cached products that consumed it are dropped at the next lookup."""
    with _RETIRED_LOCK:
        _RETIRED_STRUCTURES.add(structure_key)


def _purge_retired() -> int:
    """Drop cached products whose operands were retired; returns count."""
    with _RETIRED_LOCK:
        if not _RETIRED_STRUCTURES:
            return 0
        retired = frozenset(_RETIRED_STRUCTURES)
        _RETIRED_STRUCTURES.clear()
    return _PRODUCT_CACHE.purge(
        lambda key: key[0] in retired or key[1] in retired
    )


def product_lookup(A, B, *, method: str | None = None,
                   nzmax: int | None = None,
                   flops_max: int | None = None,
                   structure_key=None) -> tuple:
    """Cache key + LRU-served :class:`ProductPattern` for one pair.

    Products whose operand structures were retired
    (:func:`retire_structure`) are purged before the lookup, so a
    rewritten structure re-plans instead of serving stale maps.
    ``structure_key`` computes each operand's part of the key (default
    :func:`_structure_key`; the plan service passes its memoised one,
    which returns equal keys without copying a known structure to the
    host).
    """
    _purge_retired()
    sk = _structure_key if structure_key is None else structure_key
    key = (sk(A), sk(B), method, nzmax, flops_max)
    pp = _PRODUCT_CACHE.get_or_create(
        key,
        lambda: product_plan(A, B, method=method, nzmax=nzmax,
                             flops_max=flops_max),
    )
    return key, pp


def cached_product_plan(A, B, *, method: str | None = None,
                        nzmax: int | None = None,
                        flops_max: int | None = None) -> ProductPattern:
    """``product_plan`` with a host-side LRU keyed on both structures:
    repeated products over one structure pair pay only
    :meth:`ProductPattern.multiply`."""
    return product_lookup(A, B, method=method, nzmax=nzmax,
                          flops_max=flops_max)[1]


def product_cache_info() -> dict:
    """Product plan-cache state: ``size``/``capacity`` and the
    ``hits``/``misses``/``evictions``/``insertions`` counters."""
    return _PRODUCT_CACHE.info()


def product_cache_clear() -> None:
    _PRODUCT_CACHE.clear()


def product_pattern_from_arrays(fields: dict, shape, *, a_capacity: int,
                                b_capacity: int, epoch: int = 0,
                                accum: str = "sum",
                                device=None) -> ProductPattern:
    """A reference ``ProductPattern``, given as numpy arrays, as the port's.

    ``fields`` holds ``sa`` and ``sb`` and the fields of its
    ``pattern`` (``perm``, ``slot``, ``indices``, ``indptr``, ``nnz``,
    ``srows``, ``scols``), for example ``np.asarray`` of each; ``shape``
    is C's.  A product planned by the JAX package can then be refilled
    by the port.  ``device`` is ``"cuda"`` unless the caller passes
    another.
    """
    from .pattern import pattern_from_arrays

    pat = pattern_from_arrays(fields, shape, accum=accum, device=device)
    dev = pat.perm.device
    return ProductPattern(
        sa=torch.from_numpy(np.array(fields["sa"], np.int32)).to(dev),
        sb=torch.from_numpy(np.array(fields["sb"], np.int32)).to(dev),
        pattern=pat, a_capacity=int(a_capacity), b_capacity=int(b_capacity),
        epoch=int(epoch),
    )
