"""The symmetric and blocked SpMVs around B9 and B10.

Counterpart of ``repro/kernels/spmv_sym/ops.py``.  The reference runs
its Pallas kernels only while the dense vector fits its 8 MB VMEM
budget and its ``ref.py`` past it (``spmv_sym/ops.py:29-44``); the
port's kernels gather ``x`` from device memory and serve every size, so
that guard has no counterpart.  On CPU tensors the kernels run their
plain versions.  The result has the promoted dtype of the matrix and
``x``; 16-bit operands run in float32 and are cast back, and complex
ones run on the card through the float kernels one real part at a time
(:func:`~repro_torch.kernels.common.split_complex`).
"""
from __future__ import annotations

import torch

from ...core.csc import scatter_add, slot_columns
from ...sparse.pattern import accum_dtype
from ..common import on_card_complex, split_complex
from .spmv_sym import bsr_tiles, sym_streams


def spmv_sym(diag, data, indices, indptr, x, *,
             longest: int | None = None, short_column: int | None = None,
             short_mean: int | None = None) -> torch.Tensor:
    """Fused both-triangles symmetric SpMV over strict-upper storage.

    ``y = diag * x + ct + scatter_add(rows, up)``: B9 reads the halved
    stream once and returns the row-direction contributions ``up`` and
    each column's total ``ct`` (summed directly, where the reference
    differences a running sum); the row-direction scatter stays outside
    the kernel, as the reference's ``y.at[rows].add(up)`` does.
    ``longest`` (the most entries a column holds, ``SymCSC.longest``)
    picks B9's shape with the cut-offs ``short_column``/``short_mean``
    (``None``: the ``spmv_sym`` tuning policy); every value gives the
    same result.
    """
    M = diag.shape[0]
    nzmax = data.shape[-1]
    dtype = torch.promote_types(data.dtype, x.dtype)
    y = diag.to(data.dtype) * x
    if M == 0 or nzmax == 0:
        return y
    work = accum_dtype(dtype)
    rows = indices.to(torch.int32).contiguous()
    ptr = indptr.to(torch.int32).contiguous()
    shape = dict(longest=longest, short_column=short_column,
                 short_mean=short_mean)
    if on_card_complex(dtype, data.device):
        up, ct = split_complex(
            lambda a, b: sym_streams(rows, a, ptr, b, **shape), data, x)
    else:
        up, ct = sym_streams(rows, data.to(work).contiguous(), ptr,
                             x.to(work).contiguous(), **shape)
    # SymCSC streams are compact (``csc_to_symcsc`` stores exactly nnz
    # entries): the rare sentinel adds into one scratch slot
    out = y.to(work) + ct + scatter_add(M, indices, up, indices < M,
                                        scratch=1)
    return out.to(dtype)


def spmv_bsr(data, indices, indptr, x, *, shape, block: int) -> torch.Tensor:
    """Blocked SpMV: B10's per-block partial products, scatter-added into
    block rows outside the kernel (as the reference's ``.at[...].add``)."""
    M, N = shape
    b = int(block)
    nbmax = data.shape[0]
    dtype = torch.promote_types(data.dtype, x.dtype)
    if M == 0 or nbmax == 0 or b == 0:
        return torch.zeros(M, dtype=dtype, device=data.device)
    Mb, Nb = M // b, N // b
    work = accum_dtype(dtype)
    bcols = slot_columns(indptr, nbmax).clamp(0, max(Nb - 1, 0))
    brows = indices.to(torch.int32).contiguous()
    bcols = bcols.to(torch.int32).contiguous()
    if on_card_complex(dtype, data.device):
        tiles = split_complex(lambda a, b: bsr_tiles(brows, bcols, a, b,
                                                     Mb=Mb), data, x)
    else:
        tiles = bsr_tiles(brows, bcols, data.to(work).contiguous(),
                          x.to(work).contiguous(), Mb=Mb)
    # compact too (``csc_to_bsr``): padding blocks add into one scratch
    # block row
    y = scatter_add(Mb, indices, tiles, indices < Mb, scratch=1)
    return y.reshape(M).to(dtype)
