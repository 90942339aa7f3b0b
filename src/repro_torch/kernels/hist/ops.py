"""Part 1 of the counting-sort planner: histograms and block offsets.

Counterpart of ``repro/kernels/hist/ops.py``.  The per-block rows come
from B12; the reduction over blocks and the two scans stay plain
PyTorch, as the reference leaves them to XLA.

Block size.  The offsets table holds ``nblocks * nbins`` int32.  The
reference's prior block of 1,024 keys would make it 488 MB for Table
4.1 set 2 (L = 2.5e6, 50,001 bins) and 195 GB for the 5e7-triplet set
(10^6 + 1 bins).  On the card one block of keys is also one chain of
placement steps (B11), so fewer, longer blocks cost parallelism.
:func:`default_block_b` takes the power of two at or above ``nbins``,
kept within [``min_block_b``, ``max_block_b``] of the ``counting_sort``
tuning policy (priors 2^16 and 2^20): the table then holds at most about
one entry per key (4L bytes plus one row) while ``nbins <= 2^20``, and
Table 4.1's sets get 39 blocks.  The permutation does not depend on the
block size; the per-block histogram does.
"""
from __future__ import annotations

import torch

from ...sparse import tuning
from .hist import block_histogram

#: aliases of the ``counting_sort`` tuning priors
MIN_BLOCK_B = tuning.prior_value("counting_sort", "min_block_b")
MAX_BLOCK_B = tuning.prior_value("counting_sort", "max_block_b")


def policy_key(nbins: int, L=None) -> dict:
    """The sizes :func:`default_block_b` resolves the ``counting_sort``
    policy at (and the autotuner records a measured entry at): ``N`` the
    bins, ``L`` the keys."""
    return {"N": nbins, "L": L}


def default_block_b(nbins: int, *, L=None, backend=None,
                    min_block_b: int | None = None,
                    max_block_b: int | None = None) -> int:
    """Keys per block for ``nbins`` bins (see the module docstring); the
    range resolves through the ``counting_sort`` tuning policy at
    ``(nbins, L)`` on ``backend`` (a device; ``None`` is CUDA) unless
    passed."""
    if min_block_b is None or max_block_b is None:
        pol = tuning.resolve_policy("counting_sort", backend=backend,
                                    **policy_key(nbins, L))
        min_block_b = pol["min_block_b"] if min_block_b is None \
            else min_block_b
        max_block_b = pol["max_block_b"] if max_block_b is None \
            else max_block_b
    return min(max(1 << max(int(nbins) - 1, 0).bit_length(),
                   int(min_block_b)), int(max_block_b))


def histogram(keys: torch.Tensor, *, nbins: int,
              block_b: int | None = None) -> torch.Tensor:
    """Total histogram: the per-block private counters summed."""
    if keys.shape[0] == 0:
        return torch.zeros(nbins, dtype=torch.int32, device=keys.device)
    if block_b is None:
        block_b = default_block_b(nbins, L=keys.shape[0], backend=keys.device)
    per_block = block_histogram(keys, nbins=nbins, block_b=block_b)
    return per_block.sum(0, dtype=torch.int32)


def block_offsets(keys: torch.Tensor, *, nbins: int,
                  block_b: int | None = None):
    """``(offsets[nblocks, nbins], jr[nbins + 1])`` for counting-sort
    placement.

    ``offsets[b, k]`` = global start of key ``k`` + the number of
    key-``k`` elements in blocks before ``b``: the paper's private
    ``jrS`` per thread after the two hierarchical accumulations of its
    Listing 9.
    """
    if block_b is None:
        block_b = default_block_b(nbins, L=keys.shape[0], backend=keys.device)
    if keys.shape[0] == 0:
        return (torch.zeros((0, nbins), dtype=torch.int32, device=keys.device),
                torch.zeros(nbins + 1, dtype=torch.int32, device=keys.device))
    per_block = block_histogram(keys, nbins=nbins, block_b=block_b)
    totals = per_block.sum(0, dtype=torch.int32)
    jr = torch.cat([totals.new_zeros(1), torch.cumsum(totals, 0,
                                                      dtype=torch.int32)])
    prior = torch.cumsum(per_block, 0, dtype=torch.int32) - per_block
    return jr[None, :-1] + prior, jr
