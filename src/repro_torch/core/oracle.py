"""NumPy oracle emulating Matlab ``sparse`` semantics.

A copy of ``matlab_sparse_oracle`` from ``repro/core/oracle.py``, so the
port and ``chip_smoke.py`` import nothing of the JAX package.  The
duplicate sums and column counts use ``np.bincount`` where the
reference uses ``np.add.at``: the same float64 sums in the same input
order, fast enough for 5·10^7 triplets.
"""
from __future__ import annotations

import numpy as np


def matlab_sparse_oracle(ii, jj, ss, M: int, N: int):
    """(prS, irS, jcS) with Matlab semantics; zero-offset inputs.

    Duplicate (i, j) pairs are summed (in float64) and the structural
    nonzero is kept even when the sum is 0.0, as fsparse keeps it.
    Column-major (CSC) output with rows ascending within each column;
    row indices ``>= M`` are padding and dropped.
    """
    ii = np.asarray(ii, dtype=np.int64)
    jj = np.asarray(jj, dtype=np.int64)
    ss = np.asarray(ss, dtype=np.float64)
    keep = ii < M
    ii, jj, ss = ii[keep], jj[keep], ss[keep]
    order = np.lexsort((ii, jj))  # sort by col, then row (stable)
    ii, jj, ss = ii[order], jj[order], ss[order]
    if ii.size == 0:
        return (
            np.zeros(0, np.float64),
            np.zeros(0, np.int32),
            np.zeros(N + 1, np.int32),
        )
    key = jj * M + ii
    boundary = np.empty(key.shape, dtype=bool)
    boundary[0] = True
    boundary[1:] = key[1:] != key[:-1]
    slot = np.cumsum(boundary) - 1
    nnz = int(slot[-1]) + 1
    prS = np.bincount(slot, weights=ss, minlength=nnz)
    irS = np.zeros(nnz, np.int32)
    irS[slot] = ii
    jcS = np.zeros(N + 1, np.int64)
    jcS[1:] = np.bincount(jj[boundary], minlength=N)
    jcS = np.cumsum(jcS).astype(np.int32)
    return prS, irS, jcS
