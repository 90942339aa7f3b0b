"""Digit planning + the multi-pass LSD radix sort of (col, row) keys.

Counterpart of ``repro/kernels/radix_sort/ops.py``.  The pair
``(col, row)`` is one two-word key, hi word ``col``, lo word ``row``,
sorted digit by digit, row digits first.  Every pass is a stable
counting sort of one bounded digit (B1 histogram -> exclusive scan ->
B2 placement with the permutation as payload), so the composition is
the stable lexicographic (col, row) order for any ``M``/``N``.  Any
stable LSD schedule gives the same permutation, so the port's digit
plan may differ from the reference's while ``perm`` stays bit-identical.
B2 also carries the words later passes read (:func:`carried_words`),
so the next pass's key is already in order: no pass gathers it through
the permutation.

The reference picks its digit plan with a cost model of TPU VMEM and
lane tiles.  On the card every digit of at most 8 bits costs one B1 and
one B2 launch over the whole stream, and a wider digit adds at most
1.5 B per key of histogram traffic (256 counters per tile of ``TILE``
keys) against the 12-24 B a pass moves, so the fewest passes always
win: each word takes the fewest digits no wider than ``max_bits``,
split evenly.  ``max_bits`` is the planner's one knob, the
``radix_sort`` tuning policy's (:mod:`repro_torch.sparse.tuning`;
``MAX_BITS`` is an alias of its prior).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...sparse import tuning
from .radix_sort import (KERNEL_MAX_BITS, digit_block_histogram,
                         digit_placement)

#: alias of the ``radix_sort`` tuning prior (see the module docstring)
MAX_BITS = tuning.prior_value("radix_sort", "max_bits")


class DigitPass(NamedTuple):
    """One stable counting-sort pass over ``bits`` bits of one word."""

    src_col: bool   # False: digit of the row word; True: of the col word
    shift: int      # right shift applied to the word before masking
    bits: int       # digit width; mask = (1 << bits) - 1
    nbins: int      # exact bin count (<= 2**bits)


def _word_passes(vmax: int, max_bits: int,
                 src_col: bool) -> list[DigitPass]:
    """The fewest equal-width LSD digits of at most ``max_bits`` bits of
    one index word with values ``0..vmax`` (inclusive: ``vmax`` is the
    rows' padding sentinel)."""
    bits_total = max(1, int(vmax).bit_length())
    npass = -(-bits_total // max_bits)
    width = -(-bits_total // npass)
    passes = []
    shift = 0
    while shift < bits_total:
        bits = min(width, bits_total - shift)
        top = shift + bits >= bits_total
        nbins = (vmax >> shift) + 1 if top else 1 << bits
        passes.append(DigitPass(src_col, shift, bits, nbins))
        shift += bits
    return passes


def policy_key(M: int, N: int, L: int) -> dict:
    """The sizes the planner resolves the ``radix_sort`` policy at (and
    the autotuner records a measured entry at)."""
    return {"M": M, "N": N, "L": L}


def plan_digit_passes(M: int, N: int, L: int, *,
                      max_bits: int | None = None,
                      backend=None) -> tuple[DigitPass, ...]:
    """LSD pass schedule for the two-word key (col hi, row lo).

    Rows span ``0..M`` (``M`` is the padding sentinel) and cols are
    sized for ``0..N``; ``max_bits`` caps the digit width (upper bound:
    the kernels' 8 bits).  Left ``None``, it resolves through the
    ``radix_sort`` tuning policy at ``(M, N, L)`` on ``backend`` (a
    device; ``None`` is CUDA).
    """
    if max_bits is None:
        max_bits = tuning.resolve_policy(
            "radix_sort", backend=backend, **policy_key(M, N, L))["max_bits"]
    max_bits = int(max_bits)
    if not 1 <= max_bits <= KERNEL_MAX_BITS:
        raise ValueError(
            f"max_bits must be in [1, {KERNEL_MAX_BITS}], got {max_bits}"
        )
    return tuple(_word_passes(M, max_bits, False)
                 + _word_passes(N, max_bits, True))


def digit_bases(hist: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of the flattened digit-major histogram: the base
    position of every (digit, block) of one pass."""
    flat = hist.reshape(-1)
    return torch.cumsum(flat, 0, dtype=torch.int32) - flat


def _pass(keys, payload, *, carry=(), shift: int, bits: int, nbins: int):
    hist = digit_block_histogram(keys, shift=shift, bits=bits, nbins=nbins)
    return digit_placement(keys, digit_bases(hist), payload, carry=carry,
                           shift=shift, bits=bits, nbins=nbins)


def radix_pass_positions(keys: torch.Tensor, *, shift: int, bits: int,
                         nbins: int) -> torch.Tensor:
    """Landing positions of a stable sort of one digit.

    ``pos[i]`` is where element ``i`` lands when the stream is stably
    ordered by ``(keys >> shift) & (2^bits - 1)``: the inverse of one
    placement pass of the identity payload.
    """
    rank = _pass(keys, None, shift=shift, bits=bits, nbins=nbins)
    pos = torch.empty_like(rank)
    pos[rank] = torch.arange(rank.shape[0], dtype=torch.int32,
                             device=rank.device)
    return pos


def carried_words(passes, i: int) -> tuple[bool, bool]:
    """Whether pass ``i`` of ``passes`` carries ``(rows, cols)``: each
    word that a later pass reads."""
    later = passes[i + 1:]
    return (any(not p.src_col for p in later),
            any(p.src_col for p in later))


def radix_sort_pair(rows: torch.Tensor, cols: torch.Tensor, *, M: int,
                    N: int, max_bits: int | None = None) -> torch.Tensor:
    """(col, row)-stable-ordered permutation via LSD radix partitioning.

    Bit-identical to the two-pass stable sort for every ``M``/``N`` and
    every digit plan (``max_bits``, :func:`plan_digit_passes`).  Per
    pass, one B1 and one B2: the placement scatters the permutation and
    carries the words later passes read, so ``rank``, the landing
    positions and any gather through the permutation never reach device
    memory.
    """
    L = rows.shape[0]
    rows = rows.to(torch.int32).contiguous()
    cols = cols.to(torch.int32).contiguous()
    passes = plan_digit_passes(M, N, L, max_bits=max_bits,
                               backend=rows.device)
    perm = None  # identity until the first pass lands
    for i, p in enumerate(passes):
        want = carried_words(passes, i)
        carry = tuple(w for w, k in zip((rows, cols), want) if k)
        kw = dict(shift=p.shift, bits=p.bits, nbins=p.nbins)
        out = _pass(cols if p.src_col else rows, perm, carry=carry, **kw)
        if not carry:
            perm = out
            continue
        perm, moved = out
        moved = iter(moved)
        rows = next(moved) if want[0] else rows
        cols = next(moved) if want[1] else cols
    return perm
