"""repro_torch.sparse: the two-phase sparse assembly API (counterpart of
``repro.sparse``, main path only).

    >>> import numpy as np
    >>> S = fsparse([1, 2, 2], [1, 1, 2], [1.0, 2.0, 3.0], device="cpu")
    >>> int(S.nnz)
    3

Symbolic phase once per structure (``plan`` -> ``SparsePattern``),
numeric phase many times (``SparsePattern.assemble``), and the Matlab
facade on top.  Backend selection is the one ``method=`` string of
:mod:`repro_torch.sparse.dispatch`.
"""
from __future__ import annotations

from ..core.coo import COO, coo_from_matlab
from ..core.csc import CSC, csc_from_arrays, spmv, spmv_t
from .dispatch import (available_methods, default_method, register_method,
                       resolve_method, sorted_permutation)
from .errors import (CacheCorruptionWarning, CapacityWarning,
                     FallbackWarning, InvariantViolation, ReproWarning)
from .matlab import expand_indices, find, fsparse, fsparse_coo, nnz_of
from .pattern import (ACCUM_MODES, SparsePattern, pattern_from_arrays, plan,
                      plan_coo, trivial_pattern)

__all__ = [
    "ACCUM_MODES", "COO", "CSC", "CacheCorruptionWarning",
    "CapacityWarning", "FallbackWarning", "InvariantViolation",
    "ReproWarning", "SparsePattern", "available_methods", "coo_from_matlab",
    "csc_from_arrays", "default_method", "expand_indices", "find",
    "fsparse", "fsparse_coo", "nnz_of", "pattern_from_arrays", "plan",
    "plan_coo", "register_method", "resolve_method", "sorted_permutation",
    "spmv", "spmv_t", "trivial_pattern",
]
