"""Plain-PyTorch versions of the symmetric / blocked SpMV family.

Counterpart of ``repro/kernels/spmv_sym/ref.py``: :func:`spmv_sym_ref`
and :func:`spmv_bsr_ref` are the reference's whole-operator oracles
(the column direction of the symmetric product differenced out of one
global cumsum, as there).  :func:`sym_streams_ref` and
:func:`bsr_tiles_ref` are the plain versions of the port's kernels B9
and B10: the CPU path of their wrappers and what ``chip_smoke.py`` holds
them against.
"""
from __future__ import annotations

import torch

from ...core.csc import slot_columns


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


def spmv_sym_ref(diag, data, indices, indptr, x) -> torch.Tensor:
    """y = (diag(diag) + U + U.T) @ x over strict-upper CSC storage.

    Per stored entry ``a = U[i, j]`` (``i < j``): ``y[i] += a * x[j]``
    (one scatter-add over the half stream) and ``y[j] += a * x[i]``
    (cumsum boundary differences; the stream is column-sorted).
    """
    M = diag.shape[0]
    nzmax = data.shape[-1]
    y = diag.to(data.dtype) * x
    if nzmax == 0 or M == 0:
        return y
    cols = slot_columns(indptr, nzmax)
    valid = indices < M
    r = torch.where(valid, indices, 0).long()
    c = torch.where(valid, cols.clamp(0, M - 1), 0).long()
    up = torch.where(valid, data * x[c], _zero(data))   # y[i] += a * x[j]
    lo = torch.where(valid, data * x[r], _zero(data))   # y[j] += a * x[i]
    y = y.index_add(0, r, up.to(y.dtype))
    csum = torch.cat([lo.new_zeros(1), torch.cumsum(lo, 0)])
    return y + (csum[indptr[1:].long()] - csum[indptr[:-1].long()])


def spmv_bsr_ref(data, indices, indptr, x, *, shape, block) -> torch.Tensor:
    """y = A @ x over block-CSC storage: per-tile dense contraction, the
    partials scatter-added into block rows."""
    M, N = shape
    b = int(block)
    Mb, Nb = M // b, N // b
    nbmax = data.shape[0]
    dtype = torch.promote_types(data.dtype, x.dtype)
    if nbmax == 0 or M == 0:
        return torch.zeros(M, dtype=dtype, device=data.device)
    bcols = slot_columns(indptr, nbmax)
    valid = indices < Mb
    br = torch.where(valid, indices, 0).long()
    bc = torch.where(valid, bcols.clamp(0, max(Nb - 1, 0)), 0).long()
    xg = x.reshape(Nb, b)[bc]                            # [nbmax, b]
    contrib = torch.einsum("kij,kj->ki", data.to(dtype), xg.to(dtype))
    contrib = torch.where(valid[:, None], contrib, 0)
    y = torch.zeros((Mb, b), dtype=dtype, device=data.device)
    return y.index_add(0, br, contrib).reshape(M)


def sym_streams_ref(rows, data, indptr, x):
    """B9: ``(up, ct)`` of the symmetric SpMV over strict-upper CSC.

    ``up[s] = a_s * x[col_s]`` for every stored slot (0 for a sentinel
    row and for the padded tail past ``indptr[-1]``), ``ct[c]`` the sum
    of ``a_s * x[row_s]`` over column ``c``.
    """
    M = x.shape[0]
    nzmax = data.shape[0]
    cols = slot_columns(indptr, nzmax)
    inside = torch.arange(nzmax, device=data.device) < indptr[-1]
    valid = inside & (rows >= 0) & (rows < M)
    r = torch.where(valid, rows, 0).long()
    c = torch.where(valid, cols, 0).long()
    up = torch.where(valid, data * x[c], _zero(data))
    lo = torch.where(valid, data * x[r], _zero(data))
    ct = torch.zeros(M + 1, dtype=data.dtype, device=data.device)
    ct.index_add_(0, torch.where(valid, c, M), lo)
    return up, ct[:M]


def bsr_tiles_ref(brows, bcols, data, x, *, Mb: int) -> torch.Tensor:
    """B10: ``out[k, i] = sum_j data[k, i, j] * x[bcols[k] * b + j]``;
    zeros for blocks whose block row is the sentinel (``>= Mb``)."""
    b = data.shape[-1]
    valid = (brows >= 0) & (brows < Mb)
    xg = x.reshape(-1, b)[torch.where(valid, bcols, 0).long()]  # [nb, b]
    out = (data * xg[:, None, :]).sum(-1)
    return torch.where(valid[:, None], out, _zero(out))
