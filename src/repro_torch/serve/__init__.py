"""repro_torch.serve: serving entry points (counterpart of
``repro.serve``).

The sparse-assembly half: the plan service subsystem
(:mod:`repro_torch.sparse.serving`), thread-safe plan/product/executable
caches, CUDA-graph fills, products and SpMVs captured once per
structure, request batching and persistent warm restarts.
:class:`PlanService` is the front end; the runtime-environment helpers
tune the serving process the way a launcher script expects.  The model
half (``init_cache``/``prefill``/``decode_step``) waits for the LM stack
(ROADMAP queue A, item 15).
"""
from ..sparse.serving import (
    PlanService,
    apply_runtime_env,
    enable_compilation_cache,
    load_caches,
    runtime_env,
    save_caches,
    tcmalloc_hint,
)

__all__ = [
    "PlanService",
    "apply_runtime_env",
    "enable_compilation_cache",
    "load_caches",
    "runtime_env",
    "save_caches",
    "tcmalloc_hint",
]
