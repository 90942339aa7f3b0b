"""Matlab-compatibility facade over the two-phase core.

Counterpart of ``repro/sparse/matlab.py``: unit-offset indices,
duplicate summing and the paper's §2.1 index expansion, on
:func:`repro_torch.sparse.pattern.plan` + ``SparsePattern``.

  fsparse(i, j, s, [shape], [nzmax], method=...)   one-shot assembly
  sparse2(i, j, s, ...)                            assembly with a
      host-side LRU of symbolic plans: repeated calls with the same
      index vectors skip Parts 1-4 and run only the fill
  fsparse_coo(coo)                                 zero-offset entry
  plan_update / sparse2_update                     delta re-planning
      through the plan LRU (``SparsePattern.update``)
  find(S)                                          (i, j, v) unit-offset
  nnz_of(S)                                        python-int nnz
  mtimes(A, B)                                     Matlab ``A * B``

``format="symcsc"`` assembles through the halved symmetric plan
(:func:`~repro_torch.sparse.pattern.plan_symmetric`) and ``"bsr"``
groups the assembled CSC into dense tiles.  ``method="sharded"`` runs
the sharded path (:mod:`repro_torch.sparse.sharded`) over ``mesh=`` and
returns a block-row ``ShardedCSC``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.coo import COO, coo_from_host, host_triplets
from ..core.csc import CSC, slot_columns
from ..kernels.common import resolve_device
from ..launch.mesh import mesh_device
from .dispatch import resolve_method
from .lru import LRUCache
from .pattern import (SparsePattern, _host_array, plan, plan_coo,
                      plan_symmetric, validate_accum)


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
            block: int = 1, device=None):
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
    ``method=None`` resolves through the tuning table (priors:
    ``"radix"`` on the card, ``"fused"`` on the CPU). ``accum`` selects
    how duplicate (i, j) values combine
    (:data:`repro_torch.sparse.pattern.ACCUM_MODES`: Matlab's ``sparse``
    sums; the rest are ``accumarray`` reductions).

    ``format="symcsc"`` assembles through the *halved* symmetric plan
    (:func:`~repro_torch.sparse.pattern.plan_symmetric`): the structure
    must be pairwise symmetric (verified; the error names the plain-CSC
    fallback) and the duplicate-summed values must be too, the FEM
    element-matrix contract; only strict-upper and diagonal values are
    streamed.  ``format="bsr"`` assembles a plain CSC and groups it into
    dense ``block x block`` tiles.

    ``method="sharded"`` runs the sharded path
    (:mod:`repro_torch.sparse.sharded`) over ``mesh`` (default: one
    shard on ``device``, see
    :func:`~repro_torch.sparse.sharded.resolve_mesh`) and returns a
    block-row :class:`~repro_torch.sparse.sharded.ShardedCSC` on the
    mesh's device; ``convert(S, "csc")`` gives the Matlab layout.
    """
    validate_accum(accum)
    _validate_format(format, block)
    ii, jj, ss = expand_indices(ii, jj, ss)
    rows, cols, vals, shape = host_triplets(ii, jj, ss, shape)
    if method == "sharded":
        _reject_sharded_format(format)
        _reject_sharded_accum(accum)
        _reject_sharded_slack(nzmax_slack)
        mesh = _sharded_mesh(mesh, device)
        coo = coo_from_host(rows, cols, vals, shape,
                            device=mesh_device(mesh))
        return _plan_sharded_coo(coo, nzmax, mesh).assemble(coo.vals)
    device = resolve_device(device)
    method = resolve_method(method, device, M=shape[0], N=shape[1],
                            L=rows.shape[0])
    _reject_unused_mesh(mesh, method)
    if format == "symcsc":
        spat = plan_symmetric(rows, cols, shape, nzmax=nzmax, method=method,
                              accum=accum, device=device)
        return spat.assemble(torch.from_numpy(vals).to(device))
    coo = coo_from_host(rows, cols, vals, shape, device=device)
    out = fsparse_coo(coo, nzmax, method=method, accum=accum,
                      nzmax_slack=nzmax_slack)
    return _as_format(out, format, block)


def _as_format(out, format, block):
    """The plain fill's CSC in the requested ``format="bsr"`` tiles."""
    if format == "bsr":
        from .formats import convert

        return convert(out, "bsr", block=block)
    return out


def _reject_unused_mesh(mesh, method):
    if mesh is not None:
        raise ValueError(
            f"mesh= is only meaningful with method='sharded' "
            f"(got method={method!r}); the mesh would be silently ignored"
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


def _reject_sharded_format(format):
    if format is not None:
        raise NotImplementedError(
            f"format={format!r} is not supported with method='sharded': "
            "ShardedPattern routes and plans the full triplet stream per "
            "row block and knows nothing about symmetry or block tiles; "
            "fall back to the plain-CSC sharded path (format=None) and "
            "convert() the gathered result instead"
        )


def _reject_sharded_accum(accum):
    if accum != "sum":
        raise ValueError(
            f"accum={accum!r} is not supported with method='sharded' "
            "(the distributed fill reduces with scatter-add); assemble "
            "per-shard with plan(..., accum=...) or drop method='sharded'"
        )


def _reject_sharded_slack(nzmax_slack):
    if nzmax_slack:
        raise ValueError(
            "nzmax_slack is per-pattern growth headroom but sharded "
            "storage is per-block (and ShardedPattern.update is not "
            "supported); pass capacity knobs to plan_sharded directly"
        )


def _sharded_mesh(mesh, device):
    """The mesh of a ``method="sharded"`` request: ``mesh``, or the
    default mesh on ``device`` (the card unless the caller passes
    another).  The triplets go to the mesh's device, which a given
    ``device`` must name."""
    from .sharded import resolve_mesh

    mesh = resolve_mesh(mesh, device=device)
    if device is not None and _device_key(device) != _device_key(
            mesh_device(mesh)):
        raise ValueError(
            f"device={str(device)!r} differs from the mesh's device "
            f"{str(mesh_device(mesh))!r}: a sharded request runs on its "
            "mesh's device; pass one of them, or the same device to both"
        )
    return mesh


def _plan_sharded_coo(coo: COO, nzmax, mesh):
    from .sharded import plan_sharded

    if nzmax is not None:
        raise ValueError(
            "nzmax is a *global* capacity but sharded storage is "
            "per-block; pass capacity/nzmax to plan_sharded directly"
        )
    pat = plan_sharded(coo.rows, coo.cols, coo.shape, mesh=mesh)
    # overflow is a plan-time property (structure, not values): check it
    # once here, a silent drop would return a wrong matrix.  Cache hits
    # in sparse2 reuse an already-validated plan and skip the sync.
    if bool(pat.any_overflow()):
        raise ValueError(
            "sharded routing bucket overflow: the row distribution is too "
            "skewed for the default capacity; use plan_sharded(...) with a "
            "larger capacity_factor/capacity"
        )
    return pat


def fsparse_coo(coo: COO, nzmax: int | None = None, *,
                method: str | None = None, accum: str = "sum",
                nzmax_slack: int = 0) -> CSC:
    """Zero-offset COO entry point (no host validation); runs on the
    COO's device."""
    method = resolve_method(method, coo.rows.device, M=coo.shape[0],
                            N=coo.shape[1], L=coo.L)
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
    and ``block`` are part of the key, as in the reference:
    ``format="symcsc"`` caches the halved
    :class:`~repro_torch.sparse.pattern.SymPattern`, ``"bsr"`` the
    plain plan.

    The third element is the values on the plan's device, where the
    reference returns the whole COO: the row and column indices are
    copied to the device only when the plan is built, so a hit copies
    the values alone.

    ``method="sharded"`` caches
    :class:`~repro_torch.sparse.sharded.ShardedPattern` plans the same
    way, keyed also on the mesh (``mesh_fingerprint``), on the mesh's
    device.
    """
    validate_accum(accum)
    _validate_format(format, block)
    ii, jj, ss = expand_indices(ii, jj, ss)
    rows, cols, vals, shape = host_triplets(ii, jj, ss, shape)
    extra = ()
    if method == "sharded":
        from .sharded import mesh_fingerprint

        _reject_sharded_format(format)
        _reject_sharded_accum(accum)
        _reject_sharded_slack(nzmax_slack)
        mesh = _sharded_mesh(mesh, device)
        device = mesh_device(mesh)
        extra = mesh_fingerprint(mesh, "data")
    else:
        device = resolve_device(device)
        method = resolve_method(method, device, M=shape[0], N=shape[1],
                                L=rows.shape[0])
        _reject_unused_mesh(mesh, method)
        if nzmax is None and nzmax_slack:
            nzmax = int(rows.shape[0]) + int(nzmax_slack)
    key = _cache_key(rows, cols, shape, nzmax, method, device,
                     (accum, format, int(block)) + tuple(extra))

    def build():
        if method == "sharded":
            return _plan_sharded_coo(
                coo_from_host(rows, cols, vals, shape, device=device),
                nzmax, mesh)
        if format == "symcsc":
            return plan_symmetric(rows, cols, shape, nzmax=nzmax,
                                  method=method, accum=accum, device=device)
        return plan(torch.from_numpy(rows).to(device),
                    torch.from_numpy(cols).to(device), shape, nzmax=nzmax,
                    method=method, accum=accum)

    pat = _PLAN_CACHE.get_or_create(key, build)
    return key, pat, torch.from_numpy(vals).to(device)


def sparse2(ii, jj, ss, shape=None, nzmax: int | None = None, *,
            method: str | None = None, mesh=None, accum: str = "sum",
            nzmax_slack: int = 0, format: str | None = None,
            block: int = 1, device=None):
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
    call.  ``format="symcsc"`` caches the halved plan, so every refill
    streams half the values; ``format="bsr"`` groups each assembled
    result into dense tiles.  ``method="sharded"`` caches the sharded
    plan, keyed also on the mesh, so repeated sharded assembly pays the
    routing and the per-block analysis once.
    """
    _, pat, vals = plan_lookup(ii, jj, ss, shape, nzmax, method=method,
                               mesh=mesh, accum=accum,
                               nzmax_slack=nzmax_slack, format=format,
                               block=block, device=device)
    return _as_format(pat.assemble(vals), format, block)


# ---------------------------------------------------------------------------
# Delta re-planning facade (SparsePattern.update through the plan cache)
# ---------------------------------------------------------------------------
class PlanUpdate(NamedTuple):
    """Result of :func:`plan_update`.

    ``key``/``pattern`` identify the *updated* structure in the plan
    LRU; ``coo`` is the concatenated (surviving + delta) zero-offset
    triplet stream on the plan's device, whose values align with
    ``pattern`` (so ``pattern.assemble(coo.vals)`` is the updated
    matrix).  ``old_key``/``old_pattern`` are the pre-update entry, equal
    to the new ones when the update was a no-op.
    """

    key: tuple
    pattern: SparsePattern
    coo: COO
    old_key: tuple
    old_pattern: SparsePattern


def plan_update(ii, jj, ss, add_ii, add_jj, add_ss, shape=None,
                nzmax: int | None = None, *, drop_mask=None,
                method: str | None = None, accum: str = "sum",
                nzmax_slack: int = 0, device=None) -> PlanUpdate:
    """Delta re-planning through the ``sparse2`` plan cache.

    ``(ii, jj, ss, shape, nzmax[, nzmax_slack], method, accum, device)``
    identify the *base* structure exactly as a ``sparse2`` call would (a
    cold base is planned and cached first); ``add_ii``/``add_jj``/
    ``add_ss`` are unit-offset Matlab-style delta triplets (validated
    against the base shape: growing the shape is a re-plan, not an
    update) and ``drop_mask`` flags expanded base triplets to remove.
    The base plan is rewritten by
    :meth:`~repro_torch.sparse.pattern.SparsePattern.update` (epoch
    bumped, merge by key), the LRU entry moves from the old key to the
    concatenated stream's key, and dependent SpGEMM products are retired
    lazily through :func:`repro_torch.sparse.spgemm.retire_structure`.

    The new entry is keyed with the updated pattern's ``nzmax``, so a
    later ``sparse2(cat_i, cat_j, cat_s, shape,
    nzmax=result.pattern.nzmax)`` over the concatenated triplets hits it
    without re-planning.
    """
    if method == "sharded":
        raise ValueError(
            "plan_update does not support method='sharded': deltas are "
            "not routed per row block (ShardedPattern.update raises); "
            "re-plan with plan_sharded"
        )
    validate_accum(accum)
    rows_b, cols_b, vals_b, shape = host_triplets(
        *expand_indices(ii, jj, ss), shape)
    device = resolve_device(device)
    L = int(rows_b.shape[0])
    method = resolve_method(method, device, M=shape[0], N=shape[1], L=L)
    if nzmax is None and nzmax_slack:
        nzmax = L + int(nzmax_slack)
    # the extras are plan_lookup's plain-CSC identity (format=None,
    # block=1): delta updates only refine plain plans, and the keys
    # must collide with the ones sparse2 recorded
    old_key = _cache_key(rows_b, cols_b, shape, nzmax, method, device,
                         (accum, None, 1))
    base = _PLAN_CACHE.get_or_create(old_key, lambda: plan(
        torch.from_numpy(rows_b).to(device),
        torch.from_numpy(cols_b).to(device), shape, nzmax=nzmax,
        method=method, accum=accum))
    # the delta is validated against the *base* shape: an out-of-range
    # index raises Matlab's "index exceeds matrix dimensions" here
    rows_d, cols_d, vals_d, _ = host_triplets(
        *expand_indices(add_ii, add_jj, add_ss), shape)
    new_pat = base.update(rows_d, cols_d, drop_mask=drop_mask,
                          method=method)
    if drop_mask is not None:
        keep = ~_host_array(drop_mask).astype(bool)
        rows_b, cols_b, vals_b = rows_b[keep], cols_b[keep], vals_b[keep]
    rows_cat = np.concatenate([rows_b, rows_d])
    cols_cat = np.concatenate([cols_b, cols_d])
    new_coo = coo_from_host(rows_cat, cols_cat,
                            np.concatenate([vals_b, vals_d]), shape,
                            device=device)
    if new_pat is base:  # no-op update: nothing moved, nothing retired
        return PlanUpdate(old_key, base, new_coo, old_key, base)
    new_key = _cache_key(rows_cat, cols_cat, shape, new_pat.nzmax, method,
                         device, (accum, None, 1))
    _PLAN_CACHE.pop(old_key)
    new_pat = _PLAN_CACHE.insert(new_key, new_pat)
    from .spgemm import _structure_key, retire_structure

    retire_structure(_structure_key(base))
    return PlanUpdate(new_key, new_pat, new_coo, old_key, base)


def sparse2_update(ii, jj, ss, add_ii, add_jj, add_ss, shape=None,
                   nzmax: int | None = None, *, drop_mask=None,
                   method: str | None = None, accum: str = "sum",
                   nzmax_slack: int = 0, device=None) -> CSC:
    """Incrementally re-planned ``sparse2``: refine, then refill.

    Returns the assembled matrix of the concatenated (surviving base +
    delta) triplets, bit-identical to ``fsparse`` over that stream with
    the same capacity, while the cached symbolic plan is *merged
    forward* (:func:`plan_update`) instead of thrown away: only the
    delta is sorted, and later ``sparse2``/``plan_update`` calls against
    the updated structure keep hitting the cache.
    """
    res = plan_update(ii, jj, ss, add_ii, add_jj, add_ss, shape, nzmax,
                      drop_mask=drop_mask, method=method, accum=accum,
                      nzmax_slack=nzmax_slack, device=device)
    return res.pattern.assemble(res.coo.vals)


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
    whole = getattr(S, "whole", None)   # a rank ShardedCSC: every block
    if whole is not None:
        S = whole()
    total = getattr(S, "nnz_total", None)
    if total is not None:
        return int(torch.as_tensor(total))
    return int(torch.as_tensor(S.nnz).sum())
