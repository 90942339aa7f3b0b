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
:func:`merge_search_narrowed_ref` is the route of B7's dense shape in
plain PyTorch (blocks of queries narrowed together, splitters, then the
ladder), which the CPU tests hold against ``merge_search_ref``.
"""
from __future__ import annotations

import torch

from ...sparse import tuning

#: B7's shapes (``csrc/merge.cu``, :func:`merge_shape`): the dense shape's
#: queries a block and splitters a block (build-time), and the thresholds
#: on Lq and n that choose the shape (timed over a sweep of Lq and n in
#: ``PERF.md``): aliases of the ``merge`` tuning priors
BLOCK_Q = tuning.prior_value("merge", "block_q")
SPLITTERS = tuning.prior_value("merge", "splitters")
DENSE_RATIO = tuning.prior_value("merge", "dense_ratio")
SPARSE_RATIO = tuning.prior_value("merge", "sparse_ratio")
SPARSE_TARGETS = tuning.prior_value("merge", "sparse_targets")
#: the number ``csrc/merge.cu`` gives each shape
SHAPES = ("ladder", "sparse", "dense")


def policy_key(n: int) -> dict:
    """The size the ``merge`` policy (method and shape) resolves at, and
    the autotuner records a measured entry at: ``L`` the targets."""
    return {"L": n}


def merge_shape(Lq: int, n: int, *, dense_ratio: int | None = None,
                sparse_ratio: int | None = None,
                sparse_targets: int | None = None, backend=None) -> str:
    """The shape B7 takes for ``Lq`` queries into ``n`` targets:
    ``"dense"`` (queries about as many as targets: blocks narrowed
    together, :func:`merge_search_narrowed_ref`), ``"sparse"`` (few
    queries into targets past the L2: the ladder, the row read on column
    ties) or ``"ladder"`` (the ladder, both arrays at every probe).  All
    three give :func:`merge_search_ref`'s counts.  The thresholds left
    ``None`` resolve through the ``merge`` tuning policy at ``L = n`` on
    ``backend`` (``None``: CUDA)."""
    if None in (dense_ratio, sparse_ratio, sparse_targets):
        pol = tuning.resolve_policy("merge", backend=backend,
                                    **policy_key(n))
        dense_ratio = pol["dense_ratio"] if dense_ratio is None \
            else dense_ratio
        sparse_ratio = pol["sparse_ratio"] if sparse_ratio is None \
            else sparse_ratio
        sparse_targets = pol["sparse_targets"] if sparse_targets is None \
            else sparse_targets
    if Lq * dense_ratio >= n:
        return "dense"
    if Lq * sparse_ratio < n and n >= sparse_targets:
        return "sparse"
    return "ladder"


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


def pack_keys(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the ``(col, row)`` order of int32 pairs
    (B7's packing: the column in the high word, the row offset by 2^31
    in the low one)."""
    return (cols.long() << 32) + (rows.long() + 2**31)


def _count_below(tk, key, lo, hi, inclusive, probes):
    """The targets below ``key`` in ``[lo, hi)`` by rounds of ``probes``
    evenly spaced probes (B7's 32-ary warp search: 31 probes a round
    until 32 or fewer targets are left, then all of them); 1-d tensors
    of one length."""
    lanes = torch.arange(1, probes + 1, device=tk.device)
    while True:
        wide = hi - lo > probes + 1
        if not bool(wide.any()):
            break
        span = (hi - lo)[:, None]
        p = lo[:, None] + span * lanes // (probes + 1)
        p = torch.where(wide[:, None], p,
                        lo[:, None].clamp(max=tk.numel() - 1))
        b = _below_key(tk[p], key[:, None], inclusive)
        j = b.sum(1)
        pl = p.gather(1, (j - 1).clamp(min=0)[:, None])[:, 0]
        ph = p.gather(1, j.clamp(max=probes - 1)[:, None])[:, 0]
        lo = torch.where(wide & (j > 0), pl + 1, lo)
        hi = torch.where(wide & (j < probes), ph, hi)
    k = torch.arange(probes + 1, device=tk.device)
    p = (lo[:, None] + k).clamp(max=tk.numel() - 1)
    b = _below_key(tk[p], key[:, None], inclusive) & (k < (hi - lo)[:, None])
    return lo + b.sum(1)


def _below_key(tk, qk, inclusive):
    return tk <= qk if inclusive else tk < qk


def merge_search_narrowed_ref(q_rows: torch.Tensor, q_cols: torch.Tensor,
                              t_rows: torch.Tensor, t_cols: torch.Tensor, *,
                              side: str = "left", block_q: int = BLOCK_Q,
                              splitters: int = SPLITTERS) -> torch.Tensor:
    """B7's dense route, step by step, in plain PyTorch: the same counts
    as :func:`merge_search_ref` on sorted targets.

    Each block of ``block_q`` queries takes its least and greatest key
    and finds their counts ``lo0``, ``hi0`` by the 32-ary search; past
    ``splitters`` targets it reads the keys at ``lo0 + R s // splitters``
    (``R = hi0 - lo0``, ``s = 1 .. splitters - 1``) and each query keeps
    the interval between the splitters around it, which the ladder then
    halves to its end.
    """
    _check_side(side)
    n, Lq = int(t_rows.shape[0]), int(q_rows.shape[0])
    dev = q_rows.device
    if n == 0 or Lq == 0:
        return torch.zeros(Lq, dtype=torch.int32, device=dev)
    inclusive = side == "right"
    tk = pack_keys(t_rows, t_cols)
    qk = pack_keys(q_rows, q_cols)
    nb = -(-Lq // block_q)
    pad = nb * block_q - Lq
    blk = torch.cat([qk, qk[-1:].expand(pad)]).view(nb, block_q)
    zeros = torch.zeros(nb, dtype=torch.int64, device=dev)
    ends = torch.full((nb,), n, dtype=torch.int64, device=dev)
    lo0 = _count_below(tk, blk.min(1).values, zeros, ends, inclusive, 31)
    hi0 = _count_below(tk, blk.max(1).values, zeros, ends, inclusive, 31)
    b = torch.arange(Lq, device=dev) // block_q
    lo, hi = lo0[b], hi0[b]
    R = hi0 - lo0
    split = R > splitters
    if splitters > 1 and bool(split.any()):
        s = torch.arange(1, splitters, device=dev)
        pos = lo0[:, None] + R[:, None] * s // splitters
        pos = torch.where(split[:, None], pos, 0).clamp(max=n - 1)
        keys = tk[pos]                                   # [nb, S - 1]
        a = torch.searchsorted(keys[b], qk[:, None], right=inclusive)[:, 0]
        Rb, lb, sb = R[b], lo0[b], split[b]
        lo = torch.where(sb & (a > 0), lb + Rb * a // splitters + 1, lo)
        hi = torch.where(sb & (a < splitters - 1),
                         lb + Rb * (a + 1) // splitters, hi)
    while True:
        wide = hi > lo
        if not bool(wide.any()):
            break
        mid = lo + (hi - lo) // 2
        below = _below_key(tk[mid.clamp(max=n - 1)], qk, inclusive)
        lo = torch.where(wide & below, mid + 1, lo)
        hi = torch.where(wide & ~below, mid, hi)
    return lo.to(torch.int32)
