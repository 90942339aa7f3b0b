"""Padded CSC (column-compressed sparse) matrix: the assembly output.

Counterpart of ``repro/core/csc.py``.  The paper's output triplet is
``(prS, irS, jcS)`` with ``nnz`` nonzeros; the port keeps the
reference's static *capacity* ``nzmax`` (defaults to the input length
``L``) and carries the true ``nnz`` as a 0-d tensor.  Slots ``>= nnz``
hold ``row = M`` sentinels and ``val = 0``.  These functions are plain
PyTorch, as the reference's are plain jnp; autograd differentiates
them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class CSC:
    """Matlab-layout sparse matrix with static capacity.

    data    : float[nzmax]  -- ``prS``; zeros in padded tail
    indices : int32[nzmax]  -- ``irS`` zero-offset rows; ``M`` in tail
    indptr  : int32[N+1]    -- ``jcS``; indptr[N] == nnz
    nnz     : int32 0-d     -- true number of structural nonzeros
    shape   : (M, N)
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    nnz: torch.Tensor
    shape: tuple[int, int]

    @property
    def nzmax(self) -> int:
        return int(self.data.shape[-1])

    @property
    def M(self) -> int:
        return int(self.shape[0])

    @property
    def N(self) -> int:
        return int(self.shape[1])

    def to_dense(self) -> torch.Tensor:
        return csc_to_dense(self.data, self.indices, self.indptr, M=self.M,
                            N=self.N)


def slot_columns(indptr: torch.Tensor, nzmax: int) -> torch.Tensor:
    """Column index of every storage slot (padded tail -> N)."""
    slot = torch.arange(nzmax, dtype=torch.int32, device=indptr.device)
    return torch.searchsorted(indptr, slot, side="right",
                              out_int32=True) - 1


def _valid_rows_cols(indices, indptr, M: int, N: int, nzmax: int):
    valid = indices < M
    cols = slot_columns(indptr, nzmax).clamp(0, max(N - 1, 0))
    return valid, indices.where(valid, 0).long(), cols.long()


def csc_to_dense(data, indices, indptr, *, M: int, N: int) -> torch.Tensor:
    valid, rows, cols = _valid_rows_cols(indices, indptr, M, N,
                                         data.shape[0])
    dense = torch.zeros((M, N), dtype=data.dtype, device=data.device)
    return dense.index_put_((rows[valid], cols[valid]), data[valid],
                            accumulate=True)


def spmv(A: CSC, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather ``x`` by column, scatter-add by row."""
    y = torch.zeros(A.M, dtype=A.data.dtype, device=A.data.device)
    if A.M == 0 or A.N == 0:
        return y
    valid, rows, cols = _valid_rows_cols(A.indices, A.indptr, A.M, A.N,
                                         A.nzmax)
    return y.index_add(0, rows, torch.where(valid, A.data * x[cols], 0))


def spmv_t(A: CSC, y: torch.Tensor) -> torch.Tensor:
    """x = A.T @ y: gather ``y`` by row, sum per column."""
    x = torch.zeros(A.N, dtype=A.data.dtype, device=A.data.device)
    if A.M == 0 or A.N == 0:
        return x
    valid, rows, cols = _valid_rows_cols(A.indices, A.indptr, A.M, A.N,
                                         A.nzmax)
    return x.index_add(0, cols, torch.where(valid, A.data * y[rows], 0))


def csc_from_arrays(fields: dict[str, np.ndarray], shape, *,
                    device=None) -> CSC:
    """A reference ``CSC``, given as numpy arrays, as the port's.

    ``fields`` holds ``data``, ``indices``, ``indptr`` and ``nnz`` (for
    example ``{k: np.asarray(getattr(A, k)) for k in ...}`` of a
    ``repro.core.CSC``); ``data`` keeps its dtype, the structure becomes
    int32.  ``device`` is ``"cuda"`` unless the caller passes another.
    """
    device = resolve_device(device)

    def int32(k):
        return torch.from_numpy(np.array(fields[k], np.int32)).to(device)

    return CSC(data=torch.from_numpy(np.array(fields["data"])).to(device),
               indices=int32("indices"), indptr=int32("indptr"),
               nnz=int32("nnz"), shape=(int(shape[0]), int(shape[1])))
