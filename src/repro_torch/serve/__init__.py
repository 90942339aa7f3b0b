"""repro_torch.serve: serving entry points (counterpart of
``repro.serve``).

Two serving surfaces live here:

* **Model serving**: the primitives next to the model definitions
  (:mod:`repro_torch.models.model`: ``init_cache`` / ``prefill`` /
  ``decode_step``) plus the continuous-batching loop
  (``python -m repro_torch.launch.serve``, one process or, under
  ``python -m torch.distributed.run``, a mesh over the ranks).
* **Sparse-assembly serving**: the plan service subsystem
  (:mod:`repro_torch.sparse.serving`), thread-safe plan/product/
  executable caches, CUDA-graph fills, products and SpMVs captured once
  per structure, request batching and persistent warm restarts.
  :class:`PlanService` is the front end; the runtime-environment helpers
  tune the serving process the way a launcher script expects.
"""
from ..models.model import decode_step, init_cache, prefill
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
    "decode_step",
    "enable_compilation_cache",
    "init_cache",
    "load_caches",
    "prefill",
    "runtime_env",
    "save_caches",
    "tcmalloc_hint",
]
