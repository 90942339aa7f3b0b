"""NumPy oracles emulating Matlab ``sparse`` semantics.

Copies of ``repro/core/oracle.py``'s ``matlab_sparse_oracle``,
``fsparse_listing15`` (the paper's serial Listing 15, intermediates
included) and ``dense_oracle``, so the port and ``chip_smoke.py``
import nothing of the JAX package.  The
duplicate sums and column counts use ``np.bincount`` where the
reference uses ``np.add.at``, and the order is a stable sort of the key
``col * M + row`` where the reference lexsorts (row, col): the same
order and the same float64 sums in the same input order, fast enough
for 5·10^7 triplets.
"""
from __future__ import annotations

import numpy as np


def matlab_sparse_oracle(ii, jj, ss, M: int, N: int):
    """(prS, irS, jcS) with Matlab semantics; zero-offset inputs.

    Duplicate (i, j) pairs are summed (in float64) and the structural
    nonzero is kept even when the sum is 0.0, as fsparse keeps it.
    Column-major (CSC) output with rows ascending within each column;
    row indices ``>= M`` are padding and dropped.  ``ss`` may hold
    several value vectors as rows (``[k, L]``): one sort serves them
    all, and ``prS`` is then ``[k, nnz]``.
    """
    ii = np.asarray(ii, dtype=np.int64)
    jj = np.asarray(jj, dtype=np.int64)
    ss = np.asarray(ss, dtype=np.float64)
    keep = ii < M
    ii, jj, ss = ii[keep], jj[keep], ss[..., keep]
    # sort by col, then row, stable: the key is unique to (col, row)
    order = np.argsort(jj * M + ii, kind="stable")
    ii, jj, ss = ii[order], jj[order], ss[..., order]
    if ii.size == 0:
        return (
            np.zeros(ss.shape[:-1] + (0,), np.float64),
            np.zeros(0, np.int32),
            np.zeros(N + 1, np.int32),
        )
    key = jj * M + ii
    boundary = np.empty(key.shape, dtype=bool)
    boundary[0] = True
    boundary[1:] = key[1:] != key[:-1]
    slot = np.cumsum(boundary) - 1
    nnz = int(slot[-1]) + 1
    prS = np.stack([np.bincount(slot, weights=s, minlength=nnz)
                    for s in ss.reshape(-1, ss.shape[-1])]).reshape(
                        ss.shape[:-1] + (nnz,))
    irS = np.zeros(nnz, np.int32)
    irS[slot] = ii
    jcS = np.zeros(N + 1, np.int64)
    jcS[1:] = np.bincount(jj[boundary], minlength=N)
    jcS = np.cumsum(jcS).astype(np.int32)
    return prS, irS, jcS


def fsparse_listing15(ii, jj, sr, M: int, N: int):
    """Literal transcription of the paper's serial algorithm (Listing 15).

    ``ii``/``jj`` are *unit-offset* (as in the paper).  Returns the
    intermediate arrays too so tests can assert the paper's running
    example exactly: (prS, irS, jcS, rank, irank, jrS_part1).
    """
    ii = np.asarray(ii, dtype=np.int64)
    jj = np.asarray(jj, dtype=np.int64)
    sr = np.asarray(sr, dtype=np.float64)
    L = ii.size

    # Part 1: count and accumulate indices to rows  (Listing 4)
    jrS = np.zeros(M + 1, np.int64)
    for i in range(L):
        jrS[ii[i]] += 1
    for r in range(2, M + 1):
        jrS[r] += jrS[r - 1]
    jrS_part1 = jrS.copy()

    # Part 2: build rank with the active use of jrS  (Listing 5)
    rank = np.zeros(L, np.int64)
    jr = np.zeros(M + 2, np.int64)  # jrS-- trick: jr[r] == old jrS[r-1]
    jr[1:] = jrS_part1
    for i in range(L):
        rank[jr[ii[i]]] = i
        jr[ii[i]] += 1

    # Part 3: uniqueness  (Listing 6)
    jcS = np.zeros(N + 1, np.int64)
    hcol = np.zeros(N + 1, np.int64)  # hcol-- trick folded in: index by col
    irank = np.zeros(L, np.int64)
    i = 0
    for row in range(1, M + 1):
        while i < jr[row]:  # jr[row] == post-increment jrS == row end
            ixijs = rank[i]
            col = jj[ixijs]
            if hcol[col] < row:
                hcol[col] = row
                jcS[col] += 1
            irank[ixijs] = jcS[col] - 1
            i += 1

    # Part 4: accumulate pointer to columns  (Listing 7)
    for c in range(2, N + 1):
        jcS[c] += jcS[c - 1]
    for i in range(L):
        irank[i] += jcS[jj[i] - 1]  # jcS-- trick

    # Post-processing  (Listing 14)
    nnz = int(jcS[N])
    irS = np.zeros(nnz, np.int32)
    prS = np.zeros(nnz, np.float64)
    for i in range(L):
        irS[irank[i]] = ii[i] - 1
        prS[irank[i]] += sr[i]

    return prS, irS, jcS.astype(np.int32), rank, irank, jrS_part1


def dense_oracle(ii, jj, ss, M: int, N: int) -> np.ndarray:
    """Dense scatter-add oracle (zero-offset)."""
    out = np.zeros((M, N), np.float64)
    keep = np.asarray(ii) < M
    np.add.at(out, (np.asarray(ii)[keep], np.asarray(jj)[keep]),
              np.asarray(ss, dtype=np.float64)[keep])
    return out
