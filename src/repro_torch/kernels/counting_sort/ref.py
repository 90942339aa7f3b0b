"""Plain-PyTorch versions of counting-sort placement (B11).

Counterpart of ``repro/kernels/counting_sort/ref.py`` plus the plain
version of the kernel given a block-offset table.  The CPU tests run
them, the wrapper takes them for CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from ...sparse import tuning

#: keys per tile of the B11 kernel, at most -- fixed by
#: ``csrc/counting_sort.cu`` (the ``counting_sort`` spec's build-time
#: ``place_tile``)
PLACE_TILE = tuning.prior_value("counting_sort", "place_tile")


def placement_ref(keys: torch.Tensor, offsets: torch.Tensor, *, nbins: int,
                  block_b: int) -> torch.Tensor:
    """``pos[i] = offsets[b, key_i] + (keys equal to key_i earlier in
    block b)`` with ``b = i // block_b``; -1 for keys outside ``[0,
    nbins)``.

    With ``offsets`` from :func:`repro_torch.kernels.hist.ops
    .block_offsets` at the same ``block_b`` this is the landing position
    of every key in a stable sort.
    """
    L = keys.shape[0]
    dev = keys.device
    inside = (keys >= 0) & (keys < nbins)
    block = torch.arange(L, device=dev) // block_b
    size = offsets.numel()
    # (block, key) groups in input order; out-of-range keys form one
    # trailing group
    group = torch.where(inside, block * nbins + keys.long(), size)
    order = torch.sort(group, stable=True).indices
    g = group[order]
    rank = torch.arange(L, device=dev) - torch.searchsorted(g, g,
                                                             side="left")
    base = offsets.reshape(-1).long()[g.clamp(max=max(size - 1, 0))]
    pos = torch.empty(L, dtype=torch.int32, device=dev)
    pos[order] = torch.where(g < size, base + rank, -1).to(torch.int32)
    return pos


def placement_tiled_ref(keys: torch.Tensor, offsets: torch.Tensor, *,
                        nbins: int, block_b: int,
                        tile: int = PLACE_TILE) -> torch.Tensor:
    """:func:`placement_ref` by the kernel's route.

    Each block of ``block_b`` keys is cut into tiles of ``min(tile,
    block_b)`` keys.  Inside a tile, a stable sort gives each key its
    rank among the equal keys and each run of equal keys its count; then
    the tiles of every block take their bases in order, ``base =
    cnt[key]; cnt[key] += count`` for all runs of a tile at once, on a
    copy of ``offsets`` (one step per tile position, all blocks
    together).  Out-of-range keys get -1.
    """
    L = keys.shape[0]
    dev = keys.device
    if L == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    T = min(tile, block_b)
    i = torch.arange(L, device=dev)
    block, step = i // block_b, (i % block_b) // T
    tile_id = block * (-(-block_b // T)) + step
    inside = (keys >= 0) & (keys < nbins)
    k = torch.where(inside, keys.long(), nbins)  # the sentinel sorts last
    # 1. stable sort of each tile by key: ranks and runs
    order = torch.sort(tile_id * (nbins + 1) + k, stable=True).indices
    sk, st = k[order], tile_id[order]
    new = torch.ones(L, dtype=torch.bool, device=dev)
    new[1:] = (sk[1:] != sk[:-1]) | (st[1:] != st[:-1])
    start = torch.cummax(torch.where(new, i, 0), 0).values
    rank = i - start
    end = torch.ones(L, dtype=torch.bool, device=dev)
    end[:-1] = new[1:]
    kept_end = end & (sk < nbins)
    run_key, run_start = sk[kept_end], start[kept_end]
    run_count = i[kept_end] - run_start + 1
    run_block = block[order][kept_end]
    run_step = step[order][kept_end]
    # 2. the handoff along each block, one tile position at a time
    cnt = offsets.reshape(-1).long().clone()
    flat = run_block * nbins + run_key
    base = torch.empty_like(run_key)
    for s in range(int(run_step.max()) + 1 if run_key.numel() else 0):
        now = run_step == s
        base[now] = cnt[flat[now]]
        cnt.index_add_(0, flat[now], run_count[now])
    # 3. every key's base is its run's; back to input order
    run_base = torch.zeros(L, dtype=torch.long, device=dev)
    run_base[run_start] = base
    pos = torch.empty(L, dtype=torch.int32, device=dev)
    pos[order] = torch.where(sk < nbins, run_base[start] + rank, -1).to(
        torch.int32)
    return pos


def counting_sort_ref(keys: torch.Tensor):
    """``(rank, positions)``: ``rank`` is the stable argsort permutation,
    ``positions`` its inverse."""
    rank = torch.sort(keys, stable=True).indices.to(torch.int32)
    pos = torch.empty_like(rank)
    pos[rank] = torch.arange(keys.shape[0], dtype=torch.int32,
                             device=keys.device)
    return rank, pos
