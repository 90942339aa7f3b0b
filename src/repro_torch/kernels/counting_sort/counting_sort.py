"""Wrapper of the counting-sort placement CUDA kernel
(``csrc/counting_sort.cu``).

``placement`` (B11) is the counterpart of the Pallas ``placement`` of
``repro/kernels/counting_sort/counting_sort.py``: the landing position
of every key given the per-block offsets of
:func:`repro_torch.kernels.hist.ops.block_offsets` at the same block
size.  The kernel cuts each histogram block into tiles of at most
:data:`~.ref.PLACE_TILE` keys, ranks the equal keys inside a tile in
parallel, and hands the block's counters from tile to tile in order
(``csrc/counting_sort.cu``; :func:`.ref.placement_tiled_ref` is the same
route in plain PyTorch).

The wrapper takes the plain version (:mod:`.ref`) for a CPU tensor and
launches the kernel for a CUDA tensor; ``.launches`` counts kernel
launches only.  Both run inside the custom op
``torch.ops.repro_torch.placement``, which declares that it may write
``offsets`` (``consume_offsets=True`` on the card) and whose fake
implementation states the result's shape and dtype, so that fake
tensors and DTensor's ``local_map`` trace through it.
"""
from __future__ import annotations

import ctypes

import torch

from ...sparse import tuning
from ..common import (bind, cdiv, check_cuda_tensor, check_launch,
                      current_stream, load_library)
from ..hist.hist import check_keys
from .ref import placement_ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FNS: dict = {}


def _fns() -> dict:
    if not _FNS:
        lib = load_library("counting_sort")
        bind(lib, "placement_tile", [])
        if lib.placement_tile() != tuning.build_knobs(
                "counting_sort")["place_tile"]:
            raise RuntimeError("csrc/counting_sort.cu tile differs from "
                               "the counting_sort tuning spec")
        _FNS["place"] = bind(lib, "placement_launch",
                             [_P, _P, _P, _P, _LL, _I, _LL, _I, _P])
        words = lib.placement_sync_words
        words.argtypes, words.restype = [_LL], _LL
        _FNS["sync_words"] = words
    return _FNS


def placement(keys: torch.Tensor, offsets: torch.Tensor, *, nbins: int,
              block_b: int, consume_offsets: bool = False) -> torch.Tensor:
    """B11: ``int32[L]`` positions that counting-sort ``keys`` stably
    (``rank[pos[i]] = i``); -1 for keys outside ``[0, nbins)``.

    ``offsets`` is ``int32[nblocks, nbins]``.  The kernel advances its
    rows in device memory as the block's counters: on a copy, unless the
    caller hands the table over with ``consume_offsets=True`` (the
    counting sort's own temporary), and then the table is left advanced.
    Empty ``keys`` give an empty result with no launch.
    """
    return torch.ops.repro_torch.placement(keys, offsets, nbins, block_b,
                                           consume_offsets)


@torch.library.custom_op("repro_torch::placement", mutates_args=("offsets",))
def _placement_op(keys: torch.Tensor, offsets: torch.Tensor, nbins: int,
                  block_b: int, consume_offsets: bool) -> torch.Tensor:
    if keys.device.type == "cpu":
        return placement_ref(keys, offsets, nbins=nbins, block_b=block_b)
    if keys.ndim == 1 and keys.shape[0] == 0:
        check_cuda_tensor(keys, "keys", (torch.int32,))
        return torch.empty(0, dtype=torch.int32, device=keys.device)
    L = check_keys(keys, nbins, block_b)
    check_cuda_tensor(offsets, "offsets", (torch.int32,))
    nblocks = cdiv(L, block_b)
    if tuple(offsets.shape) != (nblocks, nbins):
        raise ValueError(f"offsets has shape {tuple(offsets.shape)}, "
                         f"expected (nblocks, nbins) = ({nblocks}, {nbins})")
    fns = _fns()
    work = offsets if consume_offsets else offsets.clone()
    pos = torch.empty(L, dtype=torch.int32, device=keys.device)
    # the tile ticket and the handoff flags, zeroed for every call
    sync = torch.zeros(fns["sync_words"](nblocks), dtype=torch.int32,
                       device=keys.device)
    check_launch(fns["place"](keys.data_ptr(), work.data_ptr(),
                              pos.data_ptr(), sync.data_ptr(), L, nbins,
                              block_b, nblocks, current_stream(keys.device)),
                 "placement")
    placement.launches += 1
    return pos


@_placement_op.register_fake
def _(keys, offsets, nbins, block_b, consume_offsets):
    return keys.new_empty(keys.shape, dtype=torch.int32)


placement.launches = 0
