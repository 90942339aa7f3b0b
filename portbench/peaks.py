"""The chip's peak and the bytes each operation needs.

The peak is NVIDIA's data sheet for the H100 SXM at its 700 W limit.
Assembly moves bytes and does next to no arithmetic (one addition a
duplicate), so the bytes bound every roofline here.  The byte counts
are what the operation needs, whatever implements it: each input is
read once and each output written once, from the sizes of the problem
(``L`` triplets, ``N`` columns, ``nnz`` structural nonzeros), all
indices and values 4 bytes wide.
"""
from __future__ import annotations

#: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12

WORD = 4


def plan_bytes(L: int, N: int, nnz: int) -> int:
    """Symbolic phase: read rows and cols, write one destination a
    triplet and the CSC structure (``indices`` and ``indptr``)."""
    return WORD * (3 * L + nnz + N + 1)


def fill_bytes(L: int, N: int, nnz: int) -> int:
    """Numeric phase: read the values and the destination, write the
    data."""
    del N
    return WORD * (2 * L + nnz)


def assembly_bytes(L: int, N: int, nnz: int) -> int:
    """Triplets to a finished CSC: read rows, cols and values, write
    the indices, the pointers and the data."""
    return WORD * (3 * L + 2 * nnz + N + 1)


def bound_s(nbytes: float) -> float:
    """The least time the bytes take at the HBM peak, in seconds."""
    return nbytes / HBM_BYTES_PER_S
