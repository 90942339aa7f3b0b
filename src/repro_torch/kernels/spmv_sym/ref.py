"""Plain-PyTorch versions of the symmetric / blocked SpMV family.

Counterpart of ``repro/kernels/spmv_sym/ref.py``: :func:`spmv_sym_ref`
and :func:`spmv_bsr_ref` are the reference's whole-operator oracles
(the column direction of the symmetric product differenced out of one
global cumsum, as there).  :func:`sym_streams_ref` and
:func:`bsr_tiles_ref` are the plain versions of the port's kernels B9
and B10: the CPU path of their wrappers and what ``chip_smoke.py`` holds
them against.  :func:`sym_streams_tiled_ref` is the route of B9's tiles
(the merge of column ends and slots cut into tiles, the column totals
carried across them), which the CPU tests hold against
:func:`sym_streams_ref`; B9's other shape, one thread a column adding
its slots in order, is the plain version's own order.
"""
from __future__ import annotations

import torch

from ...core.csc import slot_columns
from ...sparse import tuning

#: B9's shapes (``csrc/spmv_sym.cu``): merge items (column ends and
#: slots) a thread and a tile of 256 threads (build-time); the longest
#: column and the slots a column on average that one thread a column
#: takes (the crossings timed over streams of about 3e6 slots in
#: ``PERF.md``): aliases of the ``spmv_sym`` tuning priors
SYM_PER = tuning.prior_value("spmv_sym", "sym_per")
SYM_TILE = tuning.prior_value("spmv_sym", "threads") * SYM_PER
SHORT_COLUMN = tuning.prior_value("spmv_sym", "short_column")
SHORT_MEAN = tuning.prior_value("spmv_sym", "short_mean")


def policy_key(M: int, nzmax: int) -> dict:
    """The sizes :func:`sym_shape` resolves the ``spmv_sym`` policy at
    (and the autotuner records a measured entry at): ``M`` the columns,
    ``L`` the slots."""
    return {"M": M, "L": nzmax}


def sym_shape(longest: int | None, M: int, nzmax: int, *,
              short_column: int | None = None, short_mean: int | None = None,
              backend=None) -> str:
    """B9's shape for ``M`` columns over ``nzmax`` slots whose columns
    hold at most ``longest`` slots: ``"columns"`` (one thread a column)
    where ``longest <= short_column`` and ``nzmax <= short_mean * M``,
    else, or where ``longest`` is not known (``None``), ``"tiles"``.
    The cut-offs left ``None`` resolve through the ``spmv_sym`` tuning
    policy at ``(M, nzmax)`` on ``backend`` (``None``: CUDA)."""
    if short_column is None or short_mean is None:
        pol = tuning.resolve_policy("spmv_sym", backend=backend,
                                    **policy_key(M, nzmax))
        short_column = pol["short_column"] if short_column is None \
            else short_column
        short_mean = pol["short_mean"] if short_mean is None else short_mean
    if longest is None or longest > short_column or nzmax > short_mean * M:
        return "tiles"
    return "columns"


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


def sym_streams_tiled_ref(rows, data, indptr, x, *, tile: int = SYM_TILE):
    """The route of B9's merge-path shape in plain PyTorch: the same
    ``(up, ct)`` as :func:`sym_streams_ref`, bit for bit on
    integer-valued data.

    The work is the merge of the column ends ``indptr[1..M]`` with the
    slots ``0 .. nzmax - 1`` (slot ``s`` comes before column ``c``'s end
    iff ``s < indptr[c + 1]``), cut into tiles of ``tile`` items.  A
    slot's column is the one whose end comes next after it; slots past
    ``indptr[M]`` and sentinel rows add nothing and get ``up = 0``.  Each
    tile sums its slots' products by column in slot order (the data's
    type); a column's pieces from the tiles before the one that holds
    its end are carried, in tile order and in float64, and added to that
    tile's piece last.
    """
    M, nzmax = x.shape[0], data.shape[0]
    dev = data.device
    if M == 0:
        return (torch.zeros(nzmax, dtype=data.dtype, device=dev),
                torch.zeros(0, dtype=data.dtype, device=dev))
    s, ends, col, valid, up, lo = _slot_streams(rows, data, indptr, x)
    end_tile = (ends + torch.arange(M, device=dev)) // tile
    ct = _carried_pieces(lo[valid], col[valid], ((s + col) // tile)[valid],
                         end_tile, M, data.dtype)
    return up, ct


def _carried_pieces(lo, col, piece, end_piece, M, dtype):
    """Column totals from pieces: each slot's product goes to its
    ``(column, piece)`` in slot order (``dtype``); a column's pieces
    before ``end_piece[c]`` are carried in float64, in piece order, and
    added to that piece's sum last."""
    dev = lo.device
    npieces = int(torch.cat([piece, end_piece]).max()) + 1
    key = col * npieces + piece
    uniq, inv = torch.unique(key, return_inverse=True)
    pieces = torch.zeros(uniq.numel(), dtype=dtype, device=dev)
    pieces.index_add_(0, inv, lo)
    pc, pt = uniq // npieces, uniq % npieces
    last = pt == end_piece[pc]
    carried = torch.zeros(M, dtype=torch.float64, device=dev)
    carried.index_add_(0, pc[~last], pieces[~last].double())
    at_end = torch.zeros(M, dtype=torch.float64, device=dev)
    at_end[pc[last]] = pieces[last].double()
    return torch.zeros(M, dtype=dtype, device=dev) + \
        (carried + at_end).to(dtype)


def _slot_streams(rows, data, indptr, x):
    """Each slot's column (the end after it), validity, ``up`` and the
    product ``a_s * x[r_s]`` (0 where it adds nothing)."""
    M, nzmax = x.shape[0], data.shape[0]
    ends = indptr[1:].long()
    s = torch.arange(nzmax, device=data.device)
    col = torch.searchsorted(ends, s, right=True)
    valid = (col < M) & (rows >= 0) & (rows < M)
    r = torch.where(valid, rows, 0).long()
    c = torch.where(valid, col, 0)
    up = torch.where(valid, data * x[c], _zero(data))
    lo = torch.where(valid, data * x[r], _zero(data))
    return s, ends, col, valid, up, lo


def bsr_tiles_ref(brows, bcols, data, x, *, Mb: int) -> torch.Tensor:
    """B10: ``out[k, i] = sum_j data[k, i, j] * x[bcols[k] * b + j]``;
    zeros for blocks whose block row is the sentinel (``>= Mb``)."""
    b = data.shape[-1]
    valid = (brows >= 0) & (brows < Mb)
    xg = x.reshape(-1, b)[torch.where(valid, bcols, 0).long()]  # [nb, b]
    out = (data * xg[:, None, :]).sum(-1)
    return torch.where(valid[:, None], out, _zero(out))
