"""Static analysis & sanitizers for the port's sparse assembly stack.

Counterpart of ``repro/sparse/analysis/``; five layers, one CLI
(``python -m repro_torch.sparse.analysis``):

* :mod:`.invariants`: structural validators per registered pattern and
  format class (``validate_pattern`` / ``validate_matrix``), raising
  :class:`~repro_torch.sparse.errors.InvariantViolation` with the failed
  invariant's stable name; ``REPRO_VALIDATE=1`` turns them on inside
  ``SparsePattern.update``.
* :mod:`.contracts`: an audit of the aten ops the fill, refill,
  multiply and SpMV hot paths dispatch (no 16-bit accumulation, no host
  synchronisation, ``fill_dtype`` outputs).
* :mod:`.vmem`: the per-kernel resource report of the H100 kernels
  (threads, tiles, registers, shared memory, resident blocks an SM).
* :mod:`.concurrency`: AST lint over the modules' shared module-level
  caches: every mutation under a lock or an LRUCache method.
* :mod:`.tuning_check`: tuning-table validator (entries against the
  registered kernel specs) and an AST lint flagging policy constants in
  the dispatch/ops layer outside the :mod:`repro_torch.sparse.tuning`
  registry.

The reference's ``RetraceAuditor``/``audit_retraces`` wait for the
executable tier of ``sparse/serving.py`` (ROADMAP queue A, item 11).
"""
from __future__ import annotations

from ..errors import InvariantViolation
from .concurrency import format_findings, lint_shared_state
from .contracts import audit_default_paths, audit_jaxpr, record_ops
from .invariants import (maybe_validate_pattern, validate_matrix,
                         validate_pattern, validation_enabled,
                         validator_for_format)
from .tuning_check import (format_tuning_findings, lint_tuning_constants,
                           validate_tuning_table)
from .vmem import format_table, vmem_report

__all__ = [
    "InvariantViolation",
    "audit_default_paths",
    "audit_jaxpr",
    "format_findings",
    "format_table",
    "format_tuning_findings",
    "lint_shared_state",
    "lint_tuning_constants",
    "maybe_validate_pattern",
    "record_ops",
    "validate_matrix",
    "validate_pattern",
    "validate_tuning_table",
    "validation_enabled",
    "validator_for_format",
    "vmem_report",
]
