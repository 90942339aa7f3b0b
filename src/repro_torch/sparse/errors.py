"""Shared warning hierarchy + structured invariant violations.

A copy of ``repro/sparse/errors.py``, so both packages warn and fail
in one vocabulary.

A leaf module (no sibling imports) so every layer — dispatch, pattern,
serving, the analysis subsystem — can raise/warn through one vocabulary
without import cycles.

Warnings subclass :class:`RuntimeWarning` so existing filters
(``pytest.warns(RuntimeWarning)``, ``-W`` rules against
``RuntimeWarning``) keep matching, while CI and tests can now filter
precisely by category:

* :class:`FallbackWarning` — a fast path degraded to a slower but
  correct one (int32-overflow sort fallback, VMEM residency reroutes).
* :class:`CapacityWarning` — a static capacity was exhausted and the
  call re-planned/reallocated (``SparsePattern.update`` headroom).
* :class:`CacheCorruptionWarning` — a persisted cache entry failed to
  load or failed validation and was skipped (never served).

:class:`InvariantViolation` is the structured rejection the validator
layer (``repro.sparse.analysis.invariants``) raises: it names the
failed invariant machine-readably (``e.invariant``) so tests can pin
*which* contract a seeded corruption tripped, not just that something
raised.
"""
from __future__ import annotations


class ReproWarning(RuntimeWarning):
    """Base of every warning this package emits on purpose."""


class FallbackWarning(ReproWarning):
    """A fast path degraded to a slower, contract-identical one."""


class CapacityWarning(ReproWarning):
    """A static capacity was exhausted; the call re-planned around it."""


class CacheCorruptionWarning(ReproWarning):
    """A persisted cache entry was unreadable or invalid and skipped."""


class InvariantViolation(ValueError):
    """A structural invariant of a pattern/matrix does not hold.

    ``invariant`` is a stable kebab-case name (e.g.
    ``"perm-permutation"``, ``"indptr-monotone"``) — the machine-readable
    half of the error; ``subject`` optionally names what was validated
    (a type name, a cache entry path).
    """

    def __init__(self, invariant: str, message: str, *,
                 subject: str | None = None):
        self.invariant = str(invariant)
        self.subject = subject
        where = f" on {subject}" if subject else ""
        super().__init__(f"invariant {self.invariant!r} violated{where}: "
                         f"{message}")
