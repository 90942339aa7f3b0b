"""Wrapper of the counting-sort placement CUDA kernel
(``csrc/counting_sort.cu``).

``placement`` (B11) is the counterpart of the Pallas ``placement`` of
``repro/kernels/counting_sort/counting_sort.py``: the landing position
of every key given the per-block offsets of
:func:`repro_torch.kernels.hist.ops.block_offsets` at the same block
size.

The wrapper takes the plain version (:mod:`.ref`) for a CPU tensor and
launches the kernel for a CUDA tensor; ``.launches`` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import (bind, cdiv, check_cuda_tensor, check_launch,
                      current_stream, load_library)
from ..hist.hist import check_keys
from .ref import placement_ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FNS: dict = {}


def _fns() -> dict:
    if not _FNS:
        lib = load_library("counting_sort")
        bind(lib, "smem_optin_bytes", [])
        _FNS["smem"] = lib.smem_optin_bytes()
        if _FNS["smem"] <= 0:
            raise RuntimeError("cannot read the card's shared-memory size")
        _FNS["place"] = bind(lib, "placement_launch",
                             [_P, _P, _P, _LL, _I, _LL, _I, _I, _P])
    return _FNS


def placement(keys: torch.Tensor, offsets: torch.Tensor, *, nbins: int,
              block_b: int, consume_offsets: bool = False) -> torch.Tensor:
    """B11: ``int32[L]`` positions that counting-sort ``keys`` stably
    (``rank[pos[i]] = i``); -1 for keys outside ``[0, nbins)``.

    ``offsets`` is ``int32[nblocks, nbins]``.  When its rows do not fit
    shared memory the kernel advances them in device memory: on a copy,
    unless the caller hands the table over with
    ``consume_offsets=True`` (the counting sort's own temporary), and
    then the table is left advanced.
    """
    if keys.device.type == "cpu":
        return placement_ref(keys, offsets, nbins=nbins, block_b=block_b)
    L = check_keys(keys, nbins, block_b)
    check_cuda_tensor(offsets, "offsets", (torch.int32,))
    nblocks = cdiv(L, block_b)
    if tuple(offsets.shape) != (nblocks, nbins):
        raise ValueError(f"offsets has shape {tuple(offsets.shape)}, "
                         f"expected (nblocks, nbins) = ({nblocks}, {nbins})")
    fns = _fns()
    shared = 4 * nbins <= fns["smem"]
    work = offsets if shared or consume_offsets else offsets.clone()
    pos = torch.empty(L, dtype=torch.int32, device=keys.device)
    check_launch(fns["place"](keys.data_ptr(), work.data_ptr(),
                              pos.data_ptr(), L, nbins, block_b, nblocks,
                              int(shared), current_stream(keys.device)),
                 "placement")
    placement.launches += 1
    return pos


placement.launches = 0
