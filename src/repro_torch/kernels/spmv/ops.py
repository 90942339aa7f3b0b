"""SpMV entry point + the one-time CSC -> padded-ELL conversion.

Counterpart of ``repro/kernels/spmv/ops.py``.  The conversion is plain
PyTorch (the reference's runs in XLA outside its kernel); the product
is B8 on the card.
"""
from __future__ import annotations

import torch

from ...core.csc import CSC, slot_columns
from ...sparse.pattern import accum_dtype
from ..common import on_card_complex, split_complex
from .spmv import spmv_ell


def csc_to_ell(A: CSC, *, max_per_row: int):
    """Transpose the storage: per-row fixed-width column/value slots.

    Returns ``(cols [M, K] int32, vals [M, K], overflow)`` with ``K =
    max_per_row``; ``col == N`` pads short rows.  Rows with more than
    ``K`` entries keep their first ``K`` and raise ``overflow``, a 0-d
    bool tensor on A's device (no host synchronisation); FEM matrices
    have bounded connectivity, so the bound is structural.
    """
    M, N = A.shape
    K = int(max_per_row)
    dev = A.data.device
    cols = slot_columns(A.indptr, A.nzmax)
    valid = A.indices < M
    r = torch.where(valid, A.indices, M)
    # occurrence index of each slot within its row == counting-sort
    # placement over row keys restricted to the CSC order (stable)
    order = torch.argsort(r, stable=True)
    r_s = r[order]
    start = torch.searchsorted(
        r_s, torch.arange(M + 1, dtype=r_s.dtype, device=dev),
        out_int32=True)
    within = torch.arange(r.shape[0], dtype=torch.int32, device=dev) \
        - start[r_s.long()]
    overflow = torch.any((within >= K) & (r_s < M))
    flat = torch.where((r_s < M) & (within < K), r_s * K + within, M * K)
    flat = flat.long()
    ell_cols = torch.full((M * K + 1,), N, dtype=torch.int32, device=dev)
    ell_cols[flat] = cols.clamp(0, N)[order].to(torch.int32)
    ell_vals = torch.zeros(M * K + 1, dtype=A.data.dtype, device=dev)
    ell_vals[flat] = A.data[order]
    return (ell_cols[:M * K].reshape(M, K), ell_vals[:M * K].reshape(M, K),
            overflow)


def spmv(cols: torch.Tensor, vals: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    """Padded-ELL SpMV ``y = A @ x`` on B8 (the plain version on the CPU).

    The reference resolves its row tile ``block_r`` from its tuning
    policy; in the port it is a build-time knob of the ``spmv`` spec
    (:data:`~.spmv.BLOCK_R` = 256 rows per CUDA block, one row a thread,
    fixed by ``csrc/spmv.cu``), so there is no ``block_r`` argument. The
    result has the promoted dtype of ``vals`` and ``x``; 16-bit operands
    run in float32 and are cast back; complex ones run on the card as
    real parts.
    """
    dtype = torch.promote_types(vals.dtype, x.dtype)
    work = accum_dtype(dtype)
    cols = cols.to(torch.int32).contiguous()
    if on_card_complex(dtype, vals.device):
        # complex on the card: four real products (split_complex)
        return split_complex(lambda a, b: spmv_ell(cols, a, b), vals,
                             x).to(dtype)
    y = spmv_ell(cols, vals.to(work).contiguous(), x.to(work).contiguous())
    return y.to(dtype)
