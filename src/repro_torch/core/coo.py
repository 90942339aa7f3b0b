"""COO triplet container: the raw input of the assembly problem.

Counterpart of ``repro/core/coo.py``.  Row indices ``rows``, column
indices ``cols`` (unit-offset in the Matlab API, stored zero-offset),
values ``vals`` and the dimensions ``(M, N)``; ``row == M`` marks
padding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class COO:
    """Zero-offset COO triplets.

    rows, cols : int32[L]   (zero-offset; row == M marks padding)
    vals       : float[L]
    shape      : (M, N)     python ints
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple[int, int]

    @property
    def L(self) -> int:
        return int(self.rows.shape[-1])

    @property
    def M(self) -> int:
        return int(self.shape[0])

    @property
    def N(self) -> int:
        return int(self.shape[1])

    def __len__(self) -> int:
        return self.L

    def to_dense(self) -> torch.Tensor:
        """Dense scatter-add (duplicates sum)."""
        return coo_to_dense(self.rows, self.cols, self.vals, M=self.M,
                            N=self.N)


def coo_from_matlab(ii, jj, ss, shape=None, *, device=None) -> COO:
    """Build a :class:`COO` from Matlab-style *unit-offset* index vectors.

    Indices are validated on the host (integral, >= 1), converted to
    int32 and the dimensions inferred as the max index when ``shape`` is
    omitted; values become float32.  The tensors go to ``device``:
    ``"cuda"`` unless the caller passes another (``device="cpu"`` runs
    the plain PyTorch versions of the kernels).
    """
    return coo_from_host(*host_triplets(ii, jj, ss, shape), device=device)


def host_triplets(ii, jj, ss, shape=None):
    """The host half of :func:`coo_from_matlab`: validated zero-offset
    ``(rows, cols, vals, (M, N))`` as int32, int32 and float32 numpy
    arrays, before any copy to a device."""
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    ss = np.asarray(ss, dtype=np.float64)
    if ii.shape != jj.shape or ii.shape != ss.shape:
        raise ValueError("i, j, s must have identical shapes")
    if ii.size and (np.any(ii < 1) or np.any(ii != np.floor(ii))):
        raise ValueError("bad row index (must be positive integers)")
    if jj.size and (np.any(jj < 1) or np.any(jj != np.floor(jj))):
        raise ValueError("bad column index (must be positive integers)")
    ii = ii.astype(np.int32).ravel()
    jj = jj.astype(np.int32).ravel()
    ss = ss.ravel()
    if shape is None:
        M = int(ii.max()) if ii.size else 0
        N = int(jj.max()) if jj.size else 0
    else:
        M, N = int(shape[0]), int(shape[1])
        if ii.size and (ii.max() > M or jj.max() > N):
            raise ValueError("index exceeds matrix dimensions")
    return ii - 1, jj - 1, ss.astype(np.float32), (M, N)


def coo_from_host(rows, cols, vals, shape, *, device=None) -> COO:
    """A :class:`COO` of host arrays copied to ``device`` (``"cuda"``
    unless the caller passes another)."""
    device = resolve_device(device)
    return COO(rows=torch.from_numpy(rows).to(device),
               cols=torch.from_numpy(cols).to(device),
               vals=torch.from_numpy(vals).to(device),
               shape=(int(shape[0]), int(shape[1])))


def coo_to_dense(rows, cols, vals, *, M: int, N: int) -> torch.Tensor:
    """Dense scatter-add reference (duplicates sum: Matlab semantics)."""
    valid = rows < M
    dense = torch.zeros((M, N), dtype=vals.dtype, device=vals.device)
    return dense.index_put_(
        (rows[valid].long(), cols[valid].long()), vals[valid],
        accumulate=True,
    )
