"""Matlab's ``sparse(i, j, s, m, n)``, plainly, on the host.

The CSC of zero-offset triplets with duplicates summed: one stable sort
of the ``col * M + row`` keys (PyTorch's, on the CPU) gives the
structure: the unique keys in column order, rows ascending within a
column.  The values are summed in float64 over each run of equal keys
(NumPy).  A row index equal to ``M`` marks padding and is dropped.
Every structural nonzero is kept, also one whose terms sum to zero.

:func:`sums_bf16` is the control: the same sums computed in bfloat16,
the precision below the configurations' float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Structure:
    """The sorted order of the valid triplets and the CSC structure."""

    order: torch.Tensor  # int64[Lv]: valid input positions in key order
    starts: np.ndarray   # int64[nnz]: first position of each key's run
    indptr: np.ndarray   # int64[N + 1]
    indices: np.ndarray  # int64[nnz]: row of each structural nonzero

    @property
    def nnz(self) -> int:
        return int(self.indices.size)


def structure(rows: np.ndarray, cols: np.ndarray, shape) -> Structure:
    M, N = int(shape[0]), int(shape[1])
    r = torch.as_tensor(np.asarray(rows)).long()
    c = torch.as_tensor(np.asarray(cols)).long()
    key = c * M + r
    valid = None
    if bool((r >= M).any()):
        valid = torch.nonzero(r < M).squeeze(1)
        key = key[valid]
    del r, c
    ks, order = torch.sort(key, stable=True)
    del key
    if valid is not None:
        order = valid[order]
    first = torch.ones(ks.numel(), dtype=torch.bool)
    torch.ne(ks[1:], ks[:-1], out=first[1:])
    starts = torch.nonzero(first).squeeze(1)
    uk = ks[starts]
    # column j starts at the first unique key >= j M
    indptr = torch.searchsorted(uk, torch.arange(N + 1) * M)
    return Structure(order=order, starts=starts.numpy(),
                     indptr=indptr.numpy(), indices=(uk % M).numpy())


def _terms(vals: np.ndarray, st: Structure, dtype) -> np.ndarray:
    """The values in key order."""
    v = torch.as_tensor(np.asarray(vals, dtype=dtype))
    return v[st.order].numpy()


def _run_sums(terms: np.ndarray, st: Structure) -> np.ndarray:
    if terms.size == 0:
        return np.zeros(0, dtype=np.float64)
    return np.add.reduceat(terms, st.starts)


def sums(vals: np.ndarray, st: Structure) -> tuple[np.ndarray, np.ndarray]:
    """float64 ``(data, absum)``: each nonzero's sum and the sum of its
    terms' magnitudes."""
    terms = _terms(vals, st, np.float64)
    return _run_sums(terms, st), _run_sums(np.abs(terms), st)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (to nearest, ties to even), held
    as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


def sums_bf16(vals: np.ndarray, st: Structure) -> np.ndarray:
    """The control: values in bfloat16, each sum rounded to bfloat16."""
    terms = to_bf16(_terms(vals, st, np.float32))
    return to_bf16(_run_sums(terms.astype(np.float64), st)
                   .astype(np.float32)).astype(np.float64)
