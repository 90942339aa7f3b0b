"""Plain-PyTorch version of the two-way merge positioning search
(counterpart of ``repro/kernels/merge/ref.py``).

Merging the sorted delta stream of ``SparsePattern.update`` into a
pattern's sorted ``(col, row)`` stream is a stable two-way merge: every
element's final position is its own index plus the number of elements
of the other stream that precede it.  Counting those is a vectorised
binary search, a fixed ``bit_length(n)`` ladder of clamp, gather and
compare steps.  Keys order lexicographically by ``(col, row)`` with the
``row == M`` padding sentinel taking part like any other key.

``merge_search_ref`` is the CPU path of :func:`.merge.merge_search_kernel`
and the version ``chip_smoke.py`` holds B7 against, bit for bit.
"""
from __future__ import annotations

import torch


def search_steps(n: int) -> int:
    """Binary-search iteration count for ``n`` sorted targets: the
    active interval at least halves per step, so ``n.bit_length()``
    steps drive every query's interval below length 1."""
    return max(1, int(n).bit_length())


def _below(tc, tr, qc, qr, *, inclusive: bool):
    """Lexicographic (col, row) predicate: target precedes query."""
    row_cmp = tr <= qr if inclusive else tr < qr
    return (tc < qc) | ((tc == qc) & row_cmp)


def _check_side(side: str) -> None:
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")


def merge_search_ref(q_rows: torch.Tensor, q_cols: torch.Tensor,
                     t_rows: torch.Tensor, t_cols: torch.Tensor, *,
                     side: str = "left") -> torch.Tensor:
    """Per-query count of sorted targets preceding each query key.

    ``t_rows``/``t_cols`` must be (col, row)-lexicographically sorted;
    queries are unconstrained.  ``side="left"`` counts targets strictly
    below the query (``searchsorted`` lower bound), ``side="right"``
    counts targets at or below (upper bound).  int32 ``[Lq]``.
    """
    _check_side(side)
    n = int(t_rows.shape[0])
    Lq = int(q_rows.shape[0])
    dev = q_rows.device
    if n == 0 or Lq == 0:
        return torch.zeros(Lq, dtype=torch.int32, device=dev)
    inclusive = side == "right"
    qr, qc = q_rows.to(torch.int32), q_cols.to(torch.int32)
    tr, tc = t_rows.to(torch.int32), t_cols.to(torch.int32)
    lo = torch.zeros(Lq, dtype=torch.int32, device=dev)
    hi = torch.full((Lq,), n, dtype=torch.int32, device=dev)
    for _ in range(search_steps(n)):
        active = lo < hi
        # clamp keeps the gather in range once an interval collapses
        mid = torch.clamp((lo + hi) // 2, max=n - 1)
        m = mid.long()
        below = _below(tc[m], tr[m], qc, qr, inclusive=inclusive)
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo
