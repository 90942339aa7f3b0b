"""Wrapper of the fused fill's CUDA kernel (``csrc/segment_sum.cu``).

``gather_segment_sum`` (B3') computes what the Pallas
``gather_masked_cumsum`` of ``repro/kernels/segment_sum/segment_sum.py``
feeds into its ``_segment_totals`` epilogue, in one kernel: the
per-segment sums of ``vals[perm]`` over a sorted slot stream, with
every ``slot >= num_segments`` dropped.  It sums each segment directly
instead of differencing a global prefix sum.

The wrapper takes the plain version (:mod:`.ref`) for a CPU tensor and
launches the kernel for a CUDA tensor; ``.launches`` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import (bind, check_cuda_tensor, check_launch, current_stream,
                      load_library)
from .ref import gather_segment_sum_ref

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_FNS: dict = {}


def _fns() -> dict:
    if not _FNS:
        lib = load_library("segment_sum")
        args = [_P, _P, _P, _P, _LL, _LL, _P]
        _FNS[torch.float32] = bind(lib, "gather_segment_sum_f32_launch",
                                   args)
        _FNS[torch.float64] = bind(lib, "gather_segment_sum_f64_launch",
                                   args)
    return _FNS


def gather_segment_sum(vals: torch.Tensor, perm: torch.Tensor,
                       slot: torch.Tensor, *,
                       num_segments: int) -> torch.Tensor:
    """B3': ``[num_segments]`` sums of ``vals[perm]`` per sorted slot run.

    ``perm``/``slot`` are a plan's int32 streams (equal slots adjacent);
    ``vals`` is float32 or float64 on the card (the caller casts 16-bit
    values to float32 first; complex fills on CUDA are not ported).
    """
    if vals.device.type == "cpu":
        return gather_segment_sum_ref(vals, perm, slot,
                                      num_segments=num_segments)
    if vals.is_complex():
        raise NotImplementedError(
            "complex fills on CUDA are not ported yet (the kernel sums "
            "float32/float64); run the fill on the CPU"
        )
    check_cuda_tensor(vals, "vals", (torch.float32, torch.float64))
    check_cuda_tensor(perm, "perm", (torch.int32,))
    check_cuda_tensor(slot, "slot", (torch.int32,))
    L = perm.shape[0]
    if perm.ndim != 1 or slot.shape != perm.shape or L == 0 or L >= 2**31:
        raise ValueError(
            f"perm and slot must be equal 1-d streams with 0 < L < 2^31, "
            f"got {tuple(perm.shape)} and {tuple(slot.shape)}"
        )
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    check_launch(_fns()[vals.dtype](
        vals.data_ptr(), perm.data_ptr(), slot.data_ptr(), out.data_ptr(),
        L, num_segments, current_stream(vals.device)), "gather_segment_sum")
    gather_segment_sum.launches += 1
    return out


gather_segment_sum.launches = 0
