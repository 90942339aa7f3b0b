"""DEPRECATED shim: sharded assembly is in :mod:`repro_torch.sparse.sharded`.

Counterpart of ``repro/core/distributed.py``.  The one-shot factories
below re-run the whole symbolic analysis (histogram, routing, sort) on
*every* call, the repeated-assembly waste the paper's intermediate
format (§2.3) exists to avoid.  New code plans once and fills many
times:

    >>> from repro_torch.sparse import plan_sharded
    >>> pat = plan_sharded(rows, cols, (M, N), mesh=mesh)  # doctest: +SKIP
    >>> A = pat.assemble(vals)           # O(L) per fill   # doctest: +SKIP

:class:`ShardedCSC` is re-exported from its home so ``isinstance``
checks keep working.  Both factories run on a rank mesh too
(``make_data_mesh()`` or ``make_host_mesh(data=p)`` on a group of
ranks): every rank calls them alike, the SpMV's ``y`` is gathered to
the global vector on every rank.
"""
from __future__ import annotations

import torch

from ..launch.mesh import Mesh
from ..sparse.sharded import ShardedCSC, _sharded_spmv, plan_sharded

__all__ = ["ShardedCSC", "make_distributed_assemble", "make_distributed_spmv"]


def make_distributed_assemble(
    mesh: Mesh, *, M: int, N: int, capacity_factor: float = 2.0,
    axis: str = "data",
):
    """One-shot sharded assembly (deprecated: see the module docstring).

    Returns ``dist_assemble(rows, cols, vals) -> (ShardedCSC, overflow)``;
    internally it is ``plan_sharded(...)`` and one fill per call.
    """

    def dist_assemble(rows, cols, vals):
        pat = plan_sharded(
            rows, cols, (M, N), mesh=mesh, axis=axis,
            capacity_factor=capacity_factor,
        )
        return pat.assemble(vals), pat.any_overflow()

    return dist_assemble


def make_distributed_spmv(mesh: Mesh, *, M: int, N: int, axis: str = "data"):
    """y = A @ x with block-row ShardedCSC A; x shared.

    Deprecated: a ``ShardedCSC`` from the sharded plan path carries its
    mesh and supports ``A.spmv(x)`` / ``A @ x`` directly.  On one device
    the blocks are ``A``'s leading axis, so ``mesh`` and ``axis`` only
    keep the reference's signature; on a rank mesh ``A`` holds this
    rank's block and ``y`` is gathered over ``A``'s mesh.
    """

    def dist_spmv(A: ShardedCSC, x: torch.Tensor) -> torch.Tensor:
        if A.ranked:
            return A.spmv(x)
        return _sharded_spmv(A.data, A.indices, A.indptr, A.nnz, x,
                             shape=(M, N))

    return dist_spmv
