"""repro_torch.kernels: the hand-written CUDA kernels and their wrappers.

Layout (counterpart of ``repro.kernels``):
  hist/           Part 1 of the counting-sort planner: per-block
                  histogram (B12)
  counting_sort/  Part 2 of the counting-sort planner: stable placement
                  (B11)
  radix_sort/     Parts 1-3: LSD radix planner (B1 digit histogram,
                  B2 stable placement fused with the payload scatter)
  pattern_build/  Parts 3-4 in one pass: sorted keys, flags, their scan,
                  slots and the CSC structure (no counterpart: the
                  reference leaves them to XLA)
  segment_sum/    numeric phase: fused gather + mask + segment sum
                  (B3') and min/max (B4), prefix sum (B5), the SpGEMM
                  product segment sum (B6)
  spmv/           padded-ELL SpMV (B8) and the CSC -> ELL conversion
  spmv_sym/       symmetric SpMV streams (B9) and BSR tiles (B10)
  merge/          merge positioning search of ``SparsePattern.update``
                  and ``pattern_symmetric`` (B7)
  assembly_ops    end-to-end kernel-backed assembly, product refill and
                  the sharded fill
  common          integer helpers, the nvcc build and ctypes binding

The names below are re-exported on first access: the submodules import
``repro_torch.sparse``, which imports this package.  ``spmv`` and
``spmv_sym`` name both a subpackage and a function; as in the
reference, whose eager re-export rebinds them, the package attribute is
the function (import the subpackages by their dotted path).
"""
from __future__ import annotations

import importlib
import sys
import types

_EXPORTS = {
    "assemble_kernels": "assembly_ops", "fill_fused": "assembly_ops",
    "fill_pallas": "assembly_ops", "plan_kernels": "assembly_ops",
    "multiply_fused": "assembly_ops", "assemble_pallas": "assembly_ops",
    "plan_pallas": "assembly_ops", "fill_sharded_pallas": "assembly_ops",
    "counting_sort": "counting_sort.ops",
    "block_offsets": "hist.ops", "histogram": "hist.ops",
    "plan_digit_passes": "radix_sort.ops",
    "radix_sort_pair": "radix_sort.ops",
    "gather2_segment_sum_sorted": "segment_sum.ops",
    "gather_segment_reduce_sorted": "segment_sum.ops",
    "gather_segment_sum_sorted": "segment_sum.ops",
    "segment_sum_sorted": "segment_sum.ops",
    "blocked_cumsum": "segment_sum.segment_sum",
    "gather_segment_minmax": "segment_sum.segment_sum",
    "gather_segment_sum": "segment_sum.segment_sum",
    "gather2_segment_sum": "segment_sum.segment_sum",
    "csc_to_ell": "spmv.ops", "spmv": "spmv.ops",
    "spmv_bsr": "spmv_sym.ops", "spmv_sym": "spmv_sym.ops",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(f".{module}", __name__), name)


def _function_named(name: str) -> property:
    """The package attribute ``name``, kept the function of that name.

    ``spmv`` and ``spmv_sym`` name both a subpackage and a function.
    The import system binds the package attribute to the subpackage once
    it loads; the setter takes that assignment and drops it, so the
    attribute stays the function, as the reference's eager re-export
    leaves it.  Every other attribute is looked up as in any module.
    """
    return property(lambda self: __getattr__(name),
                    lambda self, value: None)


class _Package(types.ModuleType):
    spmv = _function_named("spmv")
    spmv_sym = _function_named("spmv_sym")


sys.modules[__name__].__class__ = _Package
