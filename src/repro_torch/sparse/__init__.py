"""repro_torch.sparse: the two-phase sparse assembly API (counterpart of
``repro.sparse``, the Matlab facade's slices so far).

    >>> import numpy as np
    >>> S = fsparse([1, 2, 2], [1, 1, 2], [1.0, 2.0, 3.0], device="cpu")
    >>> int(S.nnz)
    3

Symbolic phase once per structure (``plan`` -> ``SparsePattern``),
numeric phase many times (``SparsePattern.assemble``, under every
``accum`` mode), and the Matlab facade on top (``fsparse``, and
``sparse2`` over a plan LRU).  Backend selection is the one
``method=`` string of :mod:`repro_torch.sparse.dispatch`.
"""
from __future__ import annotations

from ..core.coo import COO, coo_from_matlab
from ..core.csc import CSC, csc_from_arrays, spmv, spmv_t
from .dispatch import (available_methods, default_method, method_from_fused,
                       register_method, resolve_method, sorted_permutation)
from .errors import (CacheCorruptionWarning, CapacityWarning,
                     FallbackWarning, InvariantViolation, ReproWarning)
from .lru import LRUCache, env_capacity
from .matlab import (expand_indices, find, fsparse, fsparse_coo, nnz_of,
                     plan_cache_clear, plan_cache_info, plan_lookup, sparse2)
from .pattern import (ACCUM_MODES, SparsePattern, accum_identity,
                      pattern_from_arrays, plan, plan_coo, trivial_pattern)

__all__ = [
    "ACCUM_MODES", "COO", "CSC", "CacheCorruptionWarning",
    "CapacityWarning", "FallbackWarning", "InvariantViolation", "LRUCache",
    "ReproWarning", "SparsePattern", "accum_identity", "available_methods",
    "coo_from_matlab", "csc_from_arrays", "default_method", "env_capacity",
    "expand_indices", "find", "fsparse", "fsparse_coo", "method_from_fused",
    "nnz_of", "pattern_from_arrays", "plan", "plan_cache_clear",
    "plan_cache_info", "plan_coo", "plan_lookup", "register_method",
    "resolve_method", "sorted_permutation", "sparse2", "spmv", "spmv_t",
    "trivial_pattern",
]
