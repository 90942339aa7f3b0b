"""The paper's benchmark data generator (Listing 12), in NumPy.

A copy of ``repro/core/ransparse.py``: the port and ``chip_smoke.py``
import nothing of the JAX package.

function [ii,jj,ss,siz] = ransparse(siz,nnz_row,nrep)
% input: size, nonzeros per row, and collisions per final element
% output: row and column indices, sparse values, and size

Data sets of Table 4.1 are exposed as :data:`DATA_SETS`.
"""
from __future__ import annotations

import numpy as np

#: Table 4.1 — (matrix size, nnz per row, collisions per element).
#: All sets have siz * nnz_row * nrep = 2,500,000 raw input elements.
DATA_SETS = {
    1: dict(siz=10_000, nnz_row=50, nrep=5),
    2: dict(siz=50_000, nnz_row=50, nrep=1),
    3: dict(siz=50_000, nnz_row=10, nrep=5),
}
# NOTE: the paper states 2.5e6 raw elements for all three sets and lists
# "collisions" 50/10/50.  siz*nnz_row gives 5e5/2.5e6/5e5; nrep of 5/1/5
# reproduces 2.5e6 raw inputs for sets 1 and 3 while set 2's 2.5e6 comes
# directly (its "10 collisions" arise statistically from random jj).


def ransparse(siz: int, nnz_row: int, nrep: int, seed: int = 0):
    """Unit-offset (ii, jj, ss, siz) mimicking the Matlab generator."""
    rng = np.random.default_rng(seed)
    ii = np.repeat(np.arange(1, siz + 1, dtype=np.int64), nnz_row)
    jj = rng.integers(1, siz + 1, size=siz * nnz_row, dtype=np.int64)
    ii = np.tile(ii, nrep)
    jj = np.tile(jj, nrep)
    p = rng.permutation(ii.size)
    ii, jj = ii[p], jj[p]
    ss = np.ones(ii.shape, np.float64)
    return ii, jj, ss, siz


def dataset(k: int, seed: int = 0, scale: float = 1.0):
    """Table-4.1 data set ``k`` (optionally scaled down for CI)."""
    cfg = dict(DATA_SETS[k])
    if scale != 1.0:
        cfg["siz"] = max(8, int(cfg["siz"] * scale))
    return ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"], seed=seed)
