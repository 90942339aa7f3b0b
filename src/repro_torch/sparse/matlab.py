"""Matlab-compatibility facade over the two-phase core.

Counterpart of ``repro/sparse/matlab.py``: unit-offset indices,
duplicate summing and the paper's §2.1 index expansion, on
:func:`repro_torch.sparse.pattern.plan` + ``SparsePattern``.

  fsparse(i, j, s, [shape], [nzmax], method=...)   one-shot assembly
  sparse2(i, j, s, ...)                            assembly with a
      host-side LRU of symbolic plans: repeated calls with the same
      index vectors skip Parts 1-4 and run only the fill
  fsparse_coo(coo)                                 zero-offset entry
  find(S)                                          (i, j, v) unit-offset
  nnz_of(S)                                        python-int nnz
  mtimes(A, B)                                     Matlab ``A * B``

Not ported yet: the delta re-planning facade, ``method="sharded"``/
``mesh=`` and the ``format=`` targets of the assembly calls (convert an
assembled CSC with :func:`repro_torch.sparse.formats.convert`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.coo import COO, coo_from_matlab, host_triplets
from ..core.csc import CSC, slot_columns
from ..kernels.common import resolve_device
from .dispatch import resolve_method
from .lru import LRUCache
from .pattern import plan, plan_coo, validate_accum


def expand_indices(ii, jj, ss):
    """fsparse index-expansion (§2.1): broadcast i (col), j (row), s.

    Elementwise mode: equal-length 1-d ``ii``/``jj`` (``ss`` scalar or
    the same length).  Outer-product mode: explicitly 2-d inputs (a
    column ``ii`` and a row ``jj``) or a scalar against a vector; ``ss``
    may be a scalar, the full (ni, nj) grid, a flat vector of ni*nj
    values, or a broadcastable (ni, 1) / (1, nj) slice.  Anything else
    raises the Matlab-compatible errors instead of silently expanding
    or crashing inside ``reshape``.
    """
    ii = np.asarray(ii, dtype=np.float64)
    jj = np.asarray(jj, dtype=np.float64)
    ss = np.asarray(ss, dtype=np.float64)
    if ii.ndim <= 1 and jj.ndim <= 1:
        if ii.size == jj.size:
            if ss.size == 1:
                ss = np.full(ii.shape, float(ss.ravel()[0]))
            elif ss.size != ii.size:
                raise ValueError("vectors must be the same length")
            return ii.ravel(), jj.ravel(), ss.ravel()
        if ii.size != 1 and jj.size != 1:
            # mismatched 1-d vectors are an error in Matlab, not an
            # implicit outer product (only scalars broadcast)
            raise ValueError("vectors must be the same length")
    # outer-product expansion: i column (ni, 1), j row (1, nj) -> (ni, nj)
    ii2 = ii.reshape(-1, 1)
    jj2 = jj.reshape(1, -1)
    ni, nj = ii2.shape[0], jj2.shape[1]
    grid_i = np.broadcast_to(ii2, (ni, nj))
    grid_j = np.broadcast_to(jj2, (ni, nj))
    if ss.size == 1:
        grid_s = np.full((ni, nj), float(ss.ravel()[0]))
    elif ss.shape == (ni, nj):
        grid_s = ss
    elif ss.ndim == 1 and ss.size == ni * nj:
        grid_s = ss.reshape(ni, nj)
    elif ss.ndim == 2 and ss.shape in ((ni, 1), (1, nj)):
        grid_s = np.broadcast_to(ss, (ni, nj))
    else:
        raise ValueError(
            f"cannot expand s of shape {ss.shape} over a ({ni}, {nj}) "
            f"index grid; expected a scalar, ({ni}, {nj}), ({ni}, 1), "
            f"(1, {nj}), or a flat vector of {ni * nj} values"
        )
    return grid_i.ravel(), grid_j.ravel(), grid_s.ravel()


def fsparse(ii, jj, ss, shape=None, nzmax: int | None = None, *,
            method: str | None = None, mesh=None, accum: str = "sum",
            nzmax_slack: int = 0, format: str | None = None,
            block: int = 1, device=None) -> CSC:
    """Assemble a sparse matrix from Matlab-style triplet data.

    >>> S = fsparse([3, 2, 3], [1, 2, 1], [7.0, 9.0, 1.0], device="cpu")
    >>> S.shape, int(S.nnz)              # duplicates at (3, 1) summed
    ((3, 2), 2)
    >>> S.to_dense()
    tensor([[0., 0.],
            [0., 9.],
            [8., 0.]])

    The triplets go to ``device``: ``"cuda"`` unless the caller passes
    another; with no card and no ``device="cpu"`` the call raises.
    ``method=None`` resolves per device (``"radix"`` on the card,
    ``"fused"`` on the CPU).  ``accum`` selects how duplicate (i, j)
    values combine (:data:`repro_torch.sparse.pattern.ACCUM_MODES`:
    Matlab's ``sparse`` sums; the rest are ``accumarray`` reductions).
    """
    _check_options(method, mesh, accum, format, block)
    ii, jj, ss = expand_indices(ii, jj, ss)
    coo = coo_from_matlab(ii, jj, ss, shape=shape, device=device)
    return fsparse_coo(coo, nzmax, method=method, accum=accum,
                       nzmax_slack=nzmax_slack)


def _check_options(method, mesh, accum, format, block):
    """The facade's option checks, in the reference's order; the options
    of later slices raise ``NotImplementedError`` naming their item."""
    if method == "sharded":
        raise NotImplementedError(
            "method='sharded' is not ported yet: the distributed assembly "
            "is a later slice of the port (ROADMAP queue A, item 14)"
        )
    validate_accum(accum)
    _validate_format(format, block)
    if format is not None:
        raise NotImplementedError(
            f"format={format!r} is not ported yet: SymCSC and BSR are a "
            "later slice of the port (ROADMAP queue A, item 9)"
        )
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: it belongs to method='sharded', a "
            "later slice of the port (ROADMAP queue A, item 14)"
        )


def _validate_format(format, block):
    if format not in (None, "symcsc", "bsr"):
        raise ValueError(
            f"unknown assembly format {format!r}; expected None "
            "(plain CSC), 'symcsc' or 'bsr'"
        )
    if int(block) < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if format != "bsr" and int(block) != 1:
        raise ValueError(
            f"block={block} is only meaningful with format='bsr' "
            f"(got format={format!r}); it would be silently ignored"
        )


def fsparse_coo(coo: COO, nzmax: int | None = None, *,
                method: str | None = None, accum: str = "sum",
                nzmax_slack: int = 0) -> CSC:
    """Zero-offset COO entry point (no host validation); runs on the
    COO's device."""
    method = resolve_method(method, coo.rows.device)
    return plan_coo(coo, nzmax=nzmax, method=method, accum=accum,
                    nzmax_slack=nzmax_slack).assemble(coo.vals)


# ---------------------------------------------------------------------------
# sparse2: pattern-caching assembly
# ---------------------------------------------------------------------------
#: the sparse2 symbolic-plan LRU.  Thread-safe (see
#: :mod:`repro_torch.sparse.lru`).  Capacity is read from
#: REPRO_PLAN_CACHE_SIZE at import; resize at runtime with
#: ``_PLAN_CACHE.resize(n)``.
_PLAN_CACHE = LRUCache(32, name="sparse2-plan", env="REPRO_PLAN_CACHE_SIZE")


def _device_key(device) -> str:
    """A device as the plan cache keys it: ``"cuda"`` names the current
    card, so it keys as ``"cuda:<index>"``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _cache_key(rows: np.ndarray, cols: np.ndarray, shape, nzmax, method,
               device, extra=()):
    """Structure-identity key for the sparse2 plan cache.

    ``tobytes()`` alone is NOT an identity: two buffers can share bytes
    while describing different structures (an int64 vector aliases two
    int32 indices; a transposed expansion shape ravels identically), so
    the dtypes and *both* shapes are part of the key.  Two points are
    the port's own: the key is built from the zero-offset host arrays,
    before they are copied to the card (no device round trip per call),
    and it holds the plan's device (a CPU plan and a CUDA plan over the
    same triplets are different resident plans).
    """
    return (rows.tobytes(), cols.tobytes(),
            rows.shape, cols.shape, rows.dtype.str, cols.dtype.str,
            tuple(shape), nzmax, method, _device_key(device), extra)


def plan_lookup(ii, jj, ss, shape=None, nzmax: int | None = None, *,
                method: str | None = None, mesh=None, accum: str = "sum",
                nzmax_slack: int = 0, format: str | None = None,
                block: int = 1, device=None):
    """The symbolic phase behind ``sparse2``: ``(key, pattern, vals)``.

    Validates and expands the Matlab-style request, keys it, and serves
    ``pattern`` from (or inserts it into) the thread-safe plan LRU.
    ``nzmax_slack`` folds into the resolved ``nzmax`` (``L + slack``)
    *before* keying, so a slack-planned structure and an explicit
    ``nzmax=L+slack`` request share one entry.  ``accum``, ``format``
    and ``block`` are part of the key, as in the reference.

    The third element is the values on the plan's device, where the
    reference returns the whole COO: the row and column indices are
    copied to the device only when the plan is built, so a hit copies
    the values alone.
    """
    _check_options(method, mesh, accum, format, block)
    ii, jj, ss = expand_indices(ii, jj, ss)
    rows, cols, vals, shape = host_triplets(ii, jj, ss, shape)
    device = resolve_device(device)
    method = resolve_method(method, device)
    if nzmax is None and nzmax_slack:
        nzmax = int(rows.shape[0]) + int(nzmax_slack)
    key = _cache_key(rows, cols, shape, nzmax, method, device,
                     (accum, format, int(block)))
    pat = _PLAN_CACHE.get_or_create(key, lambda: plan(
        torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device),
        shape, nzmax=nzmax, method=method, accum=accum))
    return key, pat, torch.from_numpy(vals).to(device)


def sparse2(ii, jj, ss, shape=None, nzmax: int | None = None, *,
            method: str | None = None, mesh=None, accum: str = "sum",
            nzmax_slack: int = 0, format: str | None = None,
            block: int = 1, device=None) -> CSC:
    """``fsparse`` with symbolic-plan reuse across calls.

    >>> S = sparse2([3, 2, 3], [1, 2, 1], [7.0, 9.0, 1.0], device="cpu")
    >>> S.to_dense()[2, 0].item(), plan_cache_info()["size"] >= 1
    (8.0, True)

    Same contract and results as :func:`fsparse`; repeated calls whose
    index vectors (and shape, nzmax, method, accum, device) are
    identical hit a thread-safe host-side LRU of
    :class:`~repro_torch.sparse.pattern.SparsePattern`
    plans and run only the O(L) numeric phase: the repeated-assembly
    FEM workflow (fixed mesh, changing element values) as a drop-in
    call.
    """
    _, pat, vals = plan_lookup(ii, jj, ss, shape, nzmax, method=method,
                               mesh=mesh, accum=accum,
                               nzmax_slack=nzmax_slack, format=format,
                               block=block, device=device)
    return pat.assemble(vals)


def plan_cache_info() -> dict:
    """sparse2 plan-cache state: ``size``/``capacity`` and the
    ``hits``/``misses``/``evictions``/``insertions`` counters."""
    return _PLAN_CACHE.info()


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()


def find(S):
    """Matlab ``[i, j, v] = find(S)``: unit-offset triplets of nonzeros.

    Host-side numpy arrays in Matlab's columnwise, row-ascending order;
    structural zeros (cancelled duplicates) are reported, as fsparse
    keeps them.  Other formats convert through the format registry
    first, so ``find`` reports the expanded structure (a SymCSC's
    mirrored lower triangle and dense diagonal included).
    """
    if not isinstance(S, CSC):
        from .formats import convert

        S = convert(S, "csc")
    nnz = int(S.nnz)
    cols = slot_columns(S.indptr, S.nzmax)[:nnz].cpu().numpy()
    rows = S.indices[:nnz].cpu().numpy()
    vals = S.data[:nnz].detach().cpu().numpy()
    return rows + 1, cols + 1, vals


def mtimes(A, B):
    """Matlab ``A * B`` on sparse operands.

    A dense ``B`` runs spmv/spmm; a sparse ``B`` (any registered format)
    runs the two-phase SpGEMM path, its symbolic product plan cached
    across calls on both structures, so repeated products such as the
    multigrid Galerkin triple product ``P' * A * P`` pay only the
    O(flops) numeric refill after the first call.

    >>> A = fsparse([1, 2], [1, 2], [2.0, 3.0], device="cpu")  # diag(2, 3)
    >>> mtimes(A, A).to_dense()
    tensor([[4., 0.],
            [0., 9.]])
    """
    from .ops import matmul

    return matmul(A, B)


def nnz_of(S) -> int:
    """Matlab ``nnz(S)``: structural nonzero count as a python int.

    Formats that store a compressed half or blocked structure (SymCSC,
    BSR) expose the Matlab-visible expanded count as ``nnz_total``,
    which is preferred here.
    """
    total = getattr(S, "nnz_total", None)
    if total is not None:
        return int(torch.as_tensor(total))
    return int(torch.as_tensor(S.nnz).sum())
