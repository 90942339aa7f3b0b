"""Plain-PyTorch versions of the radix planner's kernels (B1, B2).

The CPU tests run these, the kernel wrappers take them for CPU tensors,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.
None of them synchronises with the device (no boolean-mask
compaction), so their times on the card are device times.
Counterpart of ``repro/kernels/radix_sort/ref.py`` plus the plain
versions of ``digit_block_histogram`` and ``digit_placement``.
"""
from __future__ import annotations

import torch

from ..common import cdiv


def _digits(keys: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    return (keys >> shift) & ((1 << bits) - 1)


def digit_block_histogram_ref(keys: torch.Tensor, *, shift: int, bits: int,
                              nbins: int, tile: int) -> torch.Tensor:
    """Digit-major per-block histogram ``int32[nbins, nblocks]``.

    Block ``b`` covers keys ``[b * tile, (b + 1) * tile)``; keys whose
    digit is ``>= nbins`` count nowhere.
    """
    L = keys.shape[0]
    nblocks = cdiv(L, tile)
    d = _digits(keys, shift, bits).long()
    block = torch.arange(L, device=keys.device) // tile
    size = nbins * nblocks  # one extra bin collects out-of-contract keys
    flat = torch.where(d < nbins, d * nblocks + block, size)
    hist = torch.zeros(size + 1, dtype=torch.int32, device=keys.device)
    hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist[:size].view(nbins, nblocks)


def hist_runs(nblocks: int, sms: int, per_sm: int) -> tuple[int, int]:
    """B1's launch shape: ``(run, grid)``, block ``j`` counting tiles
    ``[j * run, min((j + 1) * run, nblocks))``.

    ``run`` is the fewest tiles a block that keeps the grid within one
    resident wave of ``per_sm`` blocks on each of ``sms`` SMs
    (``csrc/radix_sort.cu`` ``hist_run`` is the same rule); every block
    gets at least one tile.
    """
    if nblocks < 1 or sms < 1 or per_sm < 1:
        raise ValueError(f"need nblocks, sms, per_sm >= 1, got {nblocks}, "
                         f"{sms}, {per_sm}")
    run = cdiv(nblocks, sms * per_sm)
    return run, cdiv(nblocks, run)


def digit_placement_ref(keys: torch.Tensor, base: torch.Tensor,
                        payload: torch.Tensor | None = None, *,
                        carry: tuple = (), shift: int, bits: int,
                        nbins: int, tile: int):
    """``out[base[d_i, b_i] + rank_i] = payload[i]`` (identity payload if
    ``None``), where ``rank_i`` counts the earlier keys of ``i``'s block
    with ``i``'s digit ``d_i``.

    ``base`` is ``int32[nbins, nblocks]`` (or its flat view).  With the
    exclusive scan of the digit-major histogram as ``base`` this is one
    stable counting-sort pass of the payload by the digit.  Each word of
    ``carry`` is moved the same way; with any, the return is ``(out,
    carried)``.
    """
    L = keys.shape[0]
    nblocks = cdiv(L, tile)
    dev = keys.device
    d = _digits(keys, shift, bits).long()
    block = torch.arange(L, device=dev) // tile
    size = nbins * nblocks
    # (block, digit) groups in input order; out-of-contract keys form one
    # trailing group that lands in a scratch slot past the stream
    group = torch.where(d < nbins, block * nbins + d, size)
    order = torch.sort(group, stable=True).indices
    g = group[order]
    rank = torch.arange(L, device=dev) - torch.searchsorted(g, g,
                                                             side="left")
    at = (g % nbins) * nblocks + g // nbins
    pos = torch.where(g < size,
                      base.reshape(-1).long()[at.clamp(max=size - 1)] + rank,
                      L)

    def place(src: torch.Tensor) -> torch.Tensor:
        out = torch.empty(L + 1, dtype=torch.int32, device=dev)
        out[pos] = src
        return out[:L]

    out = place(order.to(torch.int32) if payload is None else payload[order])
    if not carry:
        return out
    return out, tuple(place(w[order]) for w in carry)


def digit_rank_ref(keys: torch.Tensor, *, shift: int,
                   bits: int) -> torch.Tensor:
    """Stable argsort of one extracted digit."""
    d = _digits(keys, shift, bits)
    return torch.sort(d, stable=True).indices.to(torch.int32)


def radix_sort_pair_ref(rows: torch.Tensor, cols: torch.Tensor, *, M: int,
                        N: int) -> torch.Tensor:
    """Stable (col, row) lexicographic permutation: the paper's two-pass
    composition ``rank[rank2]``."""
    del M, N
    rank = torch.sort(rows, stable=True).indices
    rank2 = torch.sort(cols[rank], stable=True).indices
    return rank[rank2].to(torch.int32)
