"""Wrapper of the per-block histogram CUDA kernel (``csrc/hist.cu``).

``block_histogram`` (B12) is the counterpart of the Pallas
``block_histogram`` of ``repro/kernels/hist/hist.py``: one private
counter row per block of keys, the paper's thread-private ``jrS``.  The
port's rows hold exactly ``nbins`` counters (the reference pads the bin
axis to its tile).

The wrapper takes the plain version (:mod:`.ref`) for a CPU tensor and
launches the kernel for a CUDA tensor; ``.launches`` counts kernel
launches only.  Both run inside the custom op
``torch.ops.repro_torch.block_histogram``, whose fake implementation
states the result's shape and dtype: fake tensors (the dry run,
``launch/dryrun.py``) and DTensor's ``local_map`` trace through it
without data.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import (bind, cdiv, check_cuda_tensor, check_launch,
                      current_stream, load_library)
from .ref import block_histogram_ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FNS: dict = {}


def _fns() -> dict:
    if not _FNS:
        lib = load_library("hist")
        bind(lib, "smem_optin_bytes", [])
        _FNS["smem"] = lib.smem_optin_bytes()
        if _FNS["smem"] <= 0:
            raise RuntimeError("cannot read the card's shared-memory size")
        _FNS["hist"] = bind(lib, "block_histogram_launch",
                            [_P, _P, _LL, _I, _LL, _I, _I, _P])
    return _FNS


def check_keys(keys: torch.Tensor, nbins: int, block_b: int) -> int:
    """What B11 and B12 need of their keys; returns L."""
    check_cuda_tensor(keys, "keys", (torch.int32,))
    L = keys.shape[0]
    if keys.ndim != 1 or L == 0 or L >= 2**31:
        raise ValueError(f"keys must be 1-d with 0 < L < 2^31, got "
                         f"{tuple(keys.shape)}")
    if not 1 <= nbins < 2**31 or block_b < 1:
        raise ValueError(f"need nbins >= 1 and block_b >= 1, got "
                         f"nbins={nbins}, block_b={block_b}")
    return L


def block_histogram(keys: torch.Tensor, *, nbins: int,
                    block_b: int) -> torch.Tensor:
    """B12: ``int32[nblocks, nbins]`` histogram of each block of
    ``block_b`` keys; keys outside ``[0, nbins)`` count nowhere."""
    return torch.ops.repro_torch.block_histogram(keys, nbins, block_b)


@torch.library.custom_op("repro_torch::block_histogram", mutates_args=())
def _block_histogram_op(keys: torch.Tensor, nbins: int,
                        block_b: int) -> torch.Tensor:
    if keys.device.type == "cpu":
        return block_histogram_ref(keys, nbins=nbins, block_b=block_b)
    L = check_keys(keys, nbins, block_b)
    fns = _fns()
    nblocks = cdiv(L, block_b)
    hist = torch.empty((nblocks, nbins), dtype=torch.int32,
                       device=keys.device)
    shared = 4 * nbins <= fns["smem"]
    check_launch(fns["hist"](keys.data_ptr(), hist.data_ptr(), L, nbins,
                             block_b, nblocks, int(shared),
                             current_stream(keys.device)), "block_histogram")
    block_histogram.launches += 1
    return hist


@_block_histogram_op.register_fake
def _(keys, nbins, block_b):
    return keys.new_empty((cdiv(keys.shape[0], block_b), nbins),
                          dtype=torch.int32)


block_histogram.launches = 0
