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

    def __matmul__(self, x):
        """``A @ x`` via ``repro_torch.sparse.ops.matmul``: one dispatch
        point, the SpMV/SpMM for a dense operand and the plan-cached
        SpGEMM for a registered sparse format."""
        from ..sparse.ops import matmul

        return matmul(self, x)


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


#: scratch slots past the end of a scatter-add's output that dropped
#: entries add into, spread by stream position
SCRATCH_SLOTS = 1024


def scatter_add(n: int, index: torch.Tensor, src: torch.Tensor,
                valid: torch.Tensor, *,
                scratch: int = SCRATCH_SLOTS) -> torch.Tensor:
    """``zeros(n, ...).at[index].add(src)`` over the entries (rows of
    ``src``) where ``valid``.

    Every other entry adds into one of ``scratch`` slots past the end,
    by its position, and is cut off.  Sending a padded tail of millions
    of entries to one slot makes them contend for one address: on an
    H100 that scatter took 19 ms of a CSC spmv with 7·10^6 entries and
    1.1·10^7 padding slots (``chip_smoke.py``'s FEM matrix).  The
    spreading costs an ``arange`` over the stream, which compact streams
    (SymCSC, BSR, slot counts) skip with ``scratch=1``.
    """
    if scratch == 1:
        idx = torch.where(valid, index, n)
    else:
        pos = torch.arange(index.shape[0], device=index.device)
        idx = torch.where(valid, index, n + pos % scratch)
    out = torch.zeros((n + scratch,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    return out.index_add_(0, idx.long(), src)[:n]


def spmv(A: CSC, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather ``x`` by column, scatter-add by row, in the
    promoted dtype of ``A.data`` and ``x``."""
    dtype = torch.promote_types(A.data.dtype, x.dtype)
    if A.M == 0 or A.N == 0:
        return torch.zeros(A.M, dtype=dtype, device=A.data.device)
    valid, rows, cols = _valid_rows_cols(A.indices, A.indptr, A.M, A.N,
                                         A.nzmax)
    return scatter_add(A.M, rows, A.data * x[cols], valid)


def spmv_t(A: CSC, y: torch.Tensor) -> torch.Tensor:
    """x = A.T @ y: gather ``y`` by row, sum per column."""
    dtype = torch.promote_types(A.data.dtype, y.dtype)
    if A.M == 0 or A.N == 0:
        return torch.zeros(A.N, dtype=dtype, device=A.data.device)
    valid, rows, cols = _valid_rows_cols(A.indices, A.indptr, A.M, A.N,
                                         A.nzmax)
    return scatter_add(A.N, cols, A.data * y[rows], valid)


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
