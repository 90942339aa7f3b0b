"""repro_torch.kernels: the hand-written CUDA kernels and their wrappers.

Layout (counterpart of ``repro.kernels``):
  hist/           Part 1 of the counting-sort planner: per-block
                  histogram (B12)
  counting_sort/  Part 2 of the counting-sort planner: stable placement
                  (B11)
  radix_sort/     Parts 1-3: LSD radix planner (B1 digit histogram,
                  B2 stable placement fused with the payload scatter)
  segment_sum/    numeric phase: fused gather + mask + segment sum
                  (B3') and min/max (B4), prefix sum (B5)
  assembly_ops    end-to-end kernel-backed assembly
  common          integer helpers, the nvcc build and ctypes binding

The names below are re-exported on first access: the submodules import
``repro_torch.sparse``, which imports this package.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "assemble_kernels": "assembly_ops", "fill_fused": "assembly_ops",
    "fill_pallas": "assembly_ops", "plan_kernels": "assembly_ops",
    "counting_sort": "counting_sort.ops",
    "block_offsets": "hist.ops", "histogram": "hist.ops",
    "plan_digit_passes": "radix_sort.ops",
    "radix_sort_pair": "radix_sort.ops",
    "gather_segment_reduce_sorted": "segment_sum.ops",
    "gather_segment_sum_sorted": "segment_sum.ops",
    "segment_sum_sorted": "segment_sum.ops",
    "blocked_cumsum": "segment_sum.segment_sum",
    "gather_segment_minmax": "segment_sum.segment_sum",
    "gather_segment_sum": "segment_sum.segment_sum",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(f".{module}", __name__), name)
