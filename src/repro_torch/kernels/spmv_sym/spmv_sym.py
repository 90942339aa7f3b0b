"""Wrappers of the symmetric-stream (B9) and BSR-tile (B10) CUDA kernels
(``csrc/spmv_sym.cu``).

``sym_streams`` (B9) computes what the Pallas ``sym_streams`` of
``repro/kernels/spmv_sym/spmv_sym.py`` feeds into ``spmv_sym``: the row
direction ``up[s] = a_s * x[col_s]`` and, where the reference emits a
running sum to be differenced at the ``indptr`` boundaries, each
column's total of ``a_s * x[row_s]`` directly.  It has two shapes, one
launch either way, picked from the longest column the caller passes
and the mean (:func:`.ref.sym_shape`): where no column holds more than
``SHORT_COLUMN`` slots and they average at most ``SHORT_MEAN``, one
thread a column; else tiles that split the merge of the column ends with
the slots and carry a column that crosses them by a look-back, so a
column of any length is spread over many blocks.
:func:`.ref.sym_streams_tiled_ref` is the tiles' route in plain PyTorch.
``bsr_tiles`` (B10) is the counterpart of ``bsr_tiles``: the partial
product of every stored block with its slice of ``x``.

Each wrapper takes its plain version (:mod:`.ref`) for a CPU tensor and
launches its kernel for a CUDA tensor; ``.launches`` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ...sparse import tuning
from ..common import (bind, cdiv, check_cuda_tensor, check_launch,
                      current_stream, load_library)
from .ref import SYM_TILE, bsr_tiles_ref, sym_shape, sym_streams_ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FNS: dict = {}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _fns() -> dict:
    if not _FNS:
        lib = load_library("spmv_sym")
        bind(lib, "sym_tile", [])
        built = tuning.build_knobs("spmv_sym")
        if lib.sym_tile() != built["threads"] * built["sym_per"]:
            raise RuntimeError("csrc/spmv_sym.cu: sym_tile() differs from "
                               "the spmv_sym tuning spec")
        for dtype, sfx in _SUFFIX.items():
            _FNS["sym", dtype] = bind(lib, f"sym_streams_{sfx}_launch",
                                      [_P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                                       _I, _P])
            _FNS["bsr", dtype] = bind(lib, f"bsr_tiles_{sfx}_launch",
                                      [_P, _P, _P, _P, _P, _LL, _LL, _I, _P])
    return _FNS


def _check_values(t: torch.Tensor, name: str, what: str) -> None:
    if t.is_complex():
        raise NotImplementedError(
            f"{what} takes float32/float64: complex values reach it as "
            "real parts through spmv_sym.ops (common.split_complex)")
    check_cuda_tensor(t, name, tuple(_SUFFIX))


def sym_streams(rows: torch.Tensor, data: torch.Tensor, indptr: torch.Tensor,
                x: torch.Tensor, *, longest: int | None = None,
                short_column: int | None = None,
                short_mean: int | None = None):
    """B9: ``(up [nzmax], ct [M])`` over SymCSC's strict-upper stream.

    ``rows``/``data`` are the stream (``M`` is the sentinel row),
    ``indptr`` int32 ``[M + 1]`` its column pointer (non-decreasing from
    0, values within the stream), ``x`` ``[M]`` of ``data``'s dtype,
    float32 or float64 on the card.  ``up`` is 0 on sentinel rows and in
    the padded tail.  The kernel writes every value of ``up`` and ``ct``;
    the scratch it takes its tile tickets and carries from is zeroed.
    ``longest`` is the most slots any column holds, as the caller knows
    it (``SymCSC.longest``); it picks the shape (:func:`.ref.sym_shape`;
    ``None``: the tiles, which serve any stream).  Every value gives the
    same results: a wrong one costs time only.  ``short_column`` and
    ``short_mean`` (``None``: the ``spmv_sym`` tuning policy) are the
    shape's cut-offs.
    """
    if data.device.type == "cpu":
        return sym_streams_ref(rows, data, indptr, x)
    _check_values(data, "data", "the symmetric SpMV")
    check_cuda_tensor(x, "x", (data.dtype,))
    check_cuda_tensor(rows, "rows", (torch.int32,))
    check_cuda_tensor(indptr, "indptr", (torch.int32,))
    M, nzmax = x.shape[0], data.shape[0]
    if (x.ndim != 1 or data.ndim != 1 or rows.shape != data.shape
            or indptr.shape != (M + 1,) or nzmax >= 2**31 or M >= 2**31):
        raise ValueError(
            f"rows/data must be equal 1-d streams and indptr [M + 1] for x "
            f"[M], got {tuple(rows.shape)}, {tuple(data.shape)}, "
            f"{tuple(indptr.shape)} and {tuple(x.shape)}")
    if M == 0:
        return torch.zeros(nzmax, dtype=data.dtype, device=data.device), \
            torch.empty(0, dtype=data.dtype, device=data.device)
    shape = sym_shape(longest, M, nzmax, short_column=short_column,
                      short_mean=short_mean, backend=data.device)
    up = torch.empty(nzmax, dtype=data.dtype, device=data.device)
    ct = torch.empty(M, dtype=data.dtype, device=data.device)
    scratch = None
    if shape == "tiles":
        words = 1 + cdiv(M + nzmax, SYM_TILE) * (
            2 if data.dtype == torch.float32 else 4)
        scratch = torch.zeros(words, dtype=torch.int64, device=data.device)
    check_launch(_fns()["sym", data.dtype](
        rows.data_ptr(), data.data_ptr(), indptr.data_ptr(), x.data_ptr(),
        up.data_ptr(), ct.data_ptr(),
        None if scratch is None else scratch.data_ptr(), M, nzmax,
        int(shape == "columns"), current_stream(data.device)), "sym_streams")
    sym_streams.launches += 1
    return up, ct


def bsr_tiles(brows: torch.Tensor, bcols: torch.Tensor, data: torch.Tensor,
              x: torch.Tensor, *, Mb: int) -> torch.Tensor:
    """B10: ``[nb, b]`` partial products of the stored blocks.

    ``brows``/``bcols`` int32 ``[nb]`` (``bcols`` within ``[0, N / b)``,
    ``brows == Mb`` marks a padding block), ``data`` ``[nb, b, b]`` and
    ``x`` ``[N]`` of one dtype, float32 or float64 on the card.
    """
    if data.device.type == "cpu":
        return bsr_tiles_ref(brows, bcols, data, x, Mb=Mb)
    _check_values(data, "data", "the BSR SpMV")
    check_cuda_tensor(x, "x", (data.dtype,))
    check_cuda_tensor(brows, "brows", (torch.int32,))
    check_cuda_tensor(bcols, "bcols", (torch.int32,))
    nb = data.shape[0]
    if (data.ndim != 3 or data.shape[1] != data.shape[2] or x.ndim != 1
            or brows.shape != (nb,) or bcols.shape != (nb,)):
        raise ValueError(
            f"data must be [nb, b, b] with brows/bcols [nb] and x 1-d, got "
            f"{tuple(data.shape)}, {tuple(brows.shape)}, "
            f"{tuple(bcols.shape)} and {tuple(x.shape)}")
    b = data.shape[1]
    out = torch.empty((nb, b), dtype=data.dtype, device=data.device)
    if nb * b == 0:
        return out
    if nb * b >= 2**31:
        raise ValueError(f"{nb} blocks of {b} rows: too many for one launch")
    check_launch(_fns()["bsr", data.dtype](
        brows.data_ptr(), bcols.data_ptr(), data.data_ptr(), x.data_ptr(),
        out.data_ptr(), nb, Mb, b, current_stream(data.device)), "bsr_tiles")
    bsr_tiles.launches += 1
    return out


sym_streams.launches = 0
bsr_tiles.launches = 0
