"""Wrapper of the padded-ELL SpMV kernel B8 (``csrc/spmv.cu``).

``spmv_ell`` computes what the Pallas ``spmv_ell`` of
``repro/kernels/spmv/spmv.py`` computes: ``y[r] = sum_k vals[r, k] *
x[cols[r, k]]`` with ``col == N`` padding, one thread per row.  It takes
its plain version (:mod:`.ref`) for a CPU tensor and launches the kernel
for a CUDA tensor; ``.launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ...sparse import tuning
from ..common import (bind, cdiv, check_cuda_tensor, check_launch,
                      current_stream, load_library)
from .ref import spmv_ell_ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FNS: dict = {}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: rows (threads) per CUDA block, fixed by ``csrc/spmv.cu``: the ``spmv``
#: spec's build-time ``block_r``
BLOCK_R = tuning.prior_value("spmv", "block_r")


def _fns() -> dict:
    if not _FNS:
        lib = load_library("spmv")
        bind(lib, "spmv_block_rows", [])
        if lib.spmv_block_rows() != tuning.build_knobs("spmv")["block_r"]:
            raise RuntimeError("csrc/spmv.cu: spmv_block_rows() differs "
                               "from the spmv tuning spec")
        for dtype, sfx in _SUFFIX.items():
            _FNS[dtype] = bind(lib, f"spmv_ell_{sfx}_launch",
                               [_P, _P, _P, _P, _LL, _I, _LL, _P])
    return _FNS


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """B8: ``[M]`` ELL products; ``cols`` int32 ``[M, K]`` in ``[0, N]``
    (``N`` is padding), ``vals`` ``[M, K]`` and ``x`` ``[N]`` of one
    dtype, float32 or float64 on the card."""
    if vals.device.type == "cpu":
        return spmv_ell_ref(cols, vals, x)
    if vals.is_complex():
        raise NotImplementedError(
            "the ELL SpMV takes float32/float64: complex values reach it "
            "as real parts through spmv.ops (common.split_complex)")
    check_cuda_tensor(vals, "vals", tuple(_SUFFIX))
    check_cuda_tensor(x, "x", (vals.dtype,))
    check_cuda_tensor(cols, "cols", (torch.int32,))
    if cols.ndim != 2 or vals.shape != cols.shape or x.ndim != 1:
        raise ValueError(
            f"cols and vals must be equal [M, K] arrays and x 1-d, got "
            f"{tuple(cols.shape)}, {tuple(vals.shape)} and {tuple(x.shape)}")
    M, K = cols.shape
    y = torch.empty(M, dtype=vals.dtype, device=vals.device)
    if M == 0:
        return y
    if cdiv(M, BLOCK_R) >= 2**31 or M * K >= 2**62:
        raise ValueError(f"ELL array too large: {M} x {K}")
    check_launch(_fns()[vals.dtype](
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), M, K,
        x.shape[0], current_stream(vals.device)), "spmv_ell")
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0
