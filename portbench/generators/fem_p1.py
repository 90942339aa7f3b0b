"""Stiffness triplets of the P1 Laplacian on a structured mesh, on the
device.

The unit square is cut into ``n x n`` cells of two right triangles each;
every triangle gives the nine triplets of its element matrix ``K``
times a coefficient of its own (a heterogeneous material), drawn from
the seed.  The vertex numbering, the triangles and the order of the
triplets are those of ``examples/fem_poisson.py``: vertex ``(x, y)`` is
``y (n + 1) + x``, the triangles of a cell are ``(v(x, y), v(x+1, y),
v(x, y+1))`` and ``(v(x+1, y+1), v(x, y+1), v(x+1, y))``.  No Dirichlet
rows.

``L = 18 n^2`` triplets into ``M = N = (n + 1)^2`` vertices with
``nnz = (n + 1)^2 + 2 (3 n^2 + 2 n)`` structural nonzeros: every vertex
and both directions of every edge (the diagonal edges included, whose
entries sum to zero).
"""
from __future__ import annotations

import torch

from .. import seeding

#: the element matrix of both triangles (right angle at the first vertex)
K = ((1.0, -0.5, -0.5), (-0.5, 0.5, 0.0), (-0.5, 0.0, 0.5))


def shape(cfg: dict) -> tuple[int, int]:
    nv = (cfg["n"] + 1) ** 2
    return nv, nv


def length(cfg: dict) -> int:
    return 18 * cfg["n"] ** 2


def nnz(cfg: dict) -> int:
    n = cfg["n"]
    return (n + 1) ** 2 + 2 * (3 * n * n + 2 * n)


def pattern(cfg: dict, seed: int, index: int, device):
    """Zero-offset int32 ``(rows, cols)``: the mesh, the same for every
    seed and index."""
    del seed, index
    n = cfg["n"]
    ar = torch.arange(n, dtype=torch.int32, device=device)
    ix, iy = ar[:, None], ar[None, :]

    def v(x, y):
        return (y * (n + 1) + x).expand(n, n)

    tri = torch.stack([
        torch.stack([v(ix, iy), v(ix + 1, iy), v(ix, iy + 1)], -1),
        torch.stack([v(ix + 1, iy + 1), v(ix, iy + 1), v(ix + 1, iy)], -1),
    ], -2)  # [n, n, 2, 3]
    full = (n, n, 2, 3, 3)
    rows = tri[..., :, None].expand(full).reshape(-1)
    cols = tri[..., None, :].expand(full).reshape(-1)
    return rows, cols


#: every index of a configuration gives the same pattern
SHARED_PATTERN = True


def values(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """float32 values: ``K`` times a coefficient a triangle, uniform on
    ``cfg["coef"]``."""
    n = cfg["n"]
    lo, hi = cfg["coef"]
    g = seeding.generator(seed, seeding.VALUES, index, device=device)
    coef = torch.empty((n, n, 2, 1, 1), dtype=torch.float32, device=device)
    coef.uniform_(lo, hi, generator=g)
    k = torch.tensor(K, dtype=torch.float32, device=device)
    return (coef * k).reshape(-1)
