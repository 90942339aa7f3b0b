"""repro_torch.sparse: the two-phase sparse assembly API (counterpart of
``repro.sparse``: the Matlab facade, the formats and the operators).

    >>> import numpy as np
    >>> S = fsparse([1, 2, 2], [1, 1, 2], [1.0, 2.0, 3.0], device="cpu")
    >>> int(S.nnz)
    3

Symbolic phase once per structure (``plan`` -> ``SparsePattern``),
numeric phase many times (``SparsePattern.assemble``, under every
``accum`` mode), and the Matlab facade on top (``fsparse``, and
``sparse2`` over a plan LRU).  Backend selection is the one
``method=`` string of :mod:`repro_torch.sparse.dispatch`.

Structures that move a little are merged forward, not re-planned
(``SparsePattern.update``; ``plan_update``/``sparse2_update`` through
the plan LRU); structurally symmetric streams plan only their upper
half (``plan_symmetric`` -> ``SymPattern``, ``format="symcsc"``).

The same split over a mesh of p shards (``plan_sharded`` ->
``ShardedPattern`` -> block-row ``ShardedCSC``) lives in
:mod:`repro_torch.sparse.sharded` and is reachable as
``method="sharded"`` from the facade; the port runs a mesh's shards
on one device.

Execution policy (sort and merge methods, digit widths, block ranges,
kernel shape thresholds) resolves through :mod:`.tuning`'s registry and
measured table; :mod:`.analysis` validates plans and formats
(``validate_pattern``/``validate_matrix``, ``REPRO_VALIDATE=1`` inside
``update``), audits the hot paths' aten ops and lints the policy layer.

The formats (CSC, COO, CSR, SymCSC, BSR, sharded) share one conversion
registry (``convert``); :mod:`~repro_torch.sparse.ops` is the operator surface
over all of them (``matmul``, ``transpose``, ``add``, ...), and a sparse
second operand of ``matmul`` (or ``mtimes``) runs the two-phase SpGEMM
(``product_plan`` once per structure pair, ``ProductPattern.multiply``
per refill).

:class:`PlanService` (:mod:`.serving`) serves all of it to concurrent
request streams: plans from the shared LRUs, persisted for warm
restarts, and each hot structure's fill, product or SpMV captured once
as a CUDA graph and replayed per request.
"""
from __future__ import annotations

from . import tuning  # before pattern: every kernels/*/ops.py resolves
from ..core.coo import COO, coo_from_matlab
from ..core.csc import CSC, csc_from_arrays, spmv, spmv_t
from .dispatch import (available_methods, default_method, method_from_fused,
                       register_method, resolve_method, sorted_permutation)
from .errors import (CacheCorruptionWarning, CapacityWarning,
                     FallbackWarning, InvariantViolation, ReproWarning)
from .formats import (BSR, CSR, SparseMatrix, SymCSC, convert, format_of,
                      from_arrays, register_converter, register_format)
from .lru import LRUCache, env_capacity
from .matlab import (PlanUpdate, expand_indices, find, fsparse, fsparse_coo,
                     mtimes, nnz_of, plan_cache_clear, plan_cache_info,
                     plan_lookup, plan_update, sparse2, sparse2_update)
from .pattern import (ACCUM_MODES, SparsePattern, SymPattern, accum_identity,
                      detect_block, detect_symmetry, pattern_from_arrays,
                      pattern_from_perm, pattern_from_sorted,
                      pattern_symmetric, plan, plan_coo, plan_symmetric,
                      sym_pattern_from_arrays, trivial_pattern)
from .sharded import (ShardedCSC, ShardedPattern, plan_sharded,
                      plan_sharded_coo)
from .spgemm import (ProductPattern, cached_product_plan, product_cache_clear,
                     product_cache_info, product_lookup, product_plan,
                     product_pattern_from_arrays, retire_structure)
from .tuning import (KernelSpec, Knob, TuningTable, kernel_spec,
                     prior_policy, register_kernel_spec,
                     registered_families, resolve_policy,
                     tuning_fingerprint)
from .analysis import validate_matrix, validate_pattern
from . import ops
from .serving import (PlanService, apply_runtime_env,
                      enable_compilation_cache, load_caches, runtime_env,
                      save_caches, tcmalloc_hint)


def assemble(coo: COO, *, nzmax: int | None = None,
             method: str | None = None) -> CSC:
    """One-shot assembly: ``plan`` + numeric fill in a single call."""
    return plan_coo(coo, nzmax=nzmax, method=method).assemble(coo.vals)


__all__ = [
    "ACCUM_MODES", "BSR", "COO", "CSC", "CSR", "CacheCorruptionWarning",
    "KernelSpec", "Knob", "TuningTable", "kernel_spec", "prior_policy",
    "register_kernel_spec", "registered_families", "resolve_policy",
    "tuning_fingerprint", "validate_matrix", "validate_pattern",
    "assemble", "pattern_from_perm", "pattern_from_sorted",
    "CapacityWarning", "FallbackWarning", "InvariantViolation", "LRUCache",
    "PlanService", "PlanUpdate", "ProductPattern", "ReproWarning",
    "ShardedCSC", "ShardedPattern", "plan_sharded", "plan_sharded_coo",
    "SparseMatrix", "apply_runtime_env", "enable_compilation_cache",
    "load_caches", "runtime_env", "save_caches", "tcmalloc_hint",
    "SparsePattern", "SymCSC", "SymPattern", "accum_identity",
    "available_methods", "cached_product_plan", "convert", "coo_from_matlab",
    "csc_from_arrays", "default_method", "detect_block", "detect_symmetry",
    "env_capacity", "expand_indices", "find", "format_of", "from_arrays",
    "fsparse", "fsparse_coo", "method_from_fused", "mtimes", "nnz_of", "ops",
    "pattern_from_arrays", "pattern_symmetric", "plan", "plan_cache_clear",
    "plan_cache_info", "plan_coo", "plan_lookup", "plan_symmetric",
    "plan_update", "product_cache_clear", "product_cache_info",
    "product_lookup", "product_pattern_from_arrays", "product_plan",
    "register_converter", "register_format", "register_method",
    "resolve_method", "retire_structure", "sorted_permutation", "sparse2",
    "sparse2_update", "spmv", "spmv_t", "sym_pattern_from_arrays",
    "trivial_pattern",
]
