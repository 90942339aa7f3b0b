"""Thread-safe, metrics-instrumented LRU: the port's one cache core.

Counterpart of ``repro/sparse/lru.py`` (pure Python there too, copied so
the port imports nothing of the JAX package).  It holds the ``sparse2``
plan cache of :mod:`repro_torch.sparse.matlab` (and ``plan_update``
moves entries in it with :meth:`LRUCache.pop`).

Design points:

* **Lock scope.**  The lock covers only the dict operations; the value
  ``factory`` of :meth:`LRUCache.get_or_create` runs *outside* it, so
  concurrent misses on different structures plan in parallel (symbolic
  planning is the expensive part; serializing it would turn the cache
  into a global bottleneck).  Two threads missing on the *same* key
  both plan, but the first insert wins and the loser adopts the
  winner's value: every caller shares one plan object and no entry is
  ever lost (plans are value-deterministic functions of the structure).
* **Metrics.**  ``hits`` / ``misses`` / ``evictions`` / ``insertions``
  are maintained under the same lock and surfaced by :meth:`info`.
* **Capacity.**  Fixed at construction, overridable by an environment
  variable (``env=``, e.g. ``REPRO_PLAN_CACHE_SIZE``) read at cache
  creation, and adjustable at runtime with :meth:`resize`.
* **Lock sanitizer.**  ``REPRO_LOCK_SANITIZE=1`` (or ``sanitize=True``)
  turns on owner/depth tracking of every lock acquisition: re-entrant
  holds are counted, and a :meth:`get_or_create` miss while the calling
  thread already holds this cache's lock raises
  :class:`~repro_torch.sparse.errors.InvariantViolation` named
  ``lock-discipline`` (planning under the cache lock serializes every
  request).  Off by default: the tracking costs two attribute writes
  per acquisition.
"""
from __future__ import annotations

import contextlib
import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable

from .errors import InvariantViolation

__all__ = ["LRUCache", "env_capacity"]


def _env_sanitize() -> bool:
    return os.environ.get("REPRO_LOCK_SANITIZE", "") \
        not in ("", "0", "false", "off")


def env_capacity(var: str | None, default: int) -> int:
    """Capacity from the environment (``var``), else ``default``.

    A present-but-malformed value raises instead of being silently
    ignored: a deployment that sets the knob wants it applied.
    """
    if var is None:
        return default
    raw = os.environ.get(var)
    if raw is None:
        return default
    try:
        cap = int(raw)
    except ValueError as e:
        raise ValueError(
            f"environment variable {var}={raw!r} is not an integer "
            "cache capacity"
        ) from e
    if cap < 1:
        raise ValueError(f"{var}={cap} — cache capacity must be >= 1")
    return cap


class LRUCache:
    """Locked LRU with hit/miss/eviction/insertion counters."""

    def __init__(self, capacity: int, *, name: str = "lru",
                 env: str | None = None, sanitize: bool | None = None):
        self.name = name
        self._capacity = env_capacity(env, capacity)
        if self._capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self._capacity}")
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.RLock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._insertions = 0
        self._sanitize = _env_sanitize() if sanitize is None \
            else bool(sanitize)
        self._owner: int | None = None   # sanitizer: holding thread id
        self._depth = 0                  # sanitizer: re-entrant hold depth
        self._reentries = 0

    @contextlib.contextmanager
    def _locked(self):
        """``self._lock`` plus owner/depth bookkeeping in sanitize mode."""
        with self._lock:
            if not self._sanitize:
                yield
                return
            me = threading.get_ident()
            self._reentries += self._owner == me
            self._owner = me
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
                if self._depth == 0:
                    self._owner = None

    def holds_lock(self) -> bool:
        """True when the current thread holds this cache's lock.

        Only meaningful in sanitize mode, where acquisitions through
        the cache's own methods track ownership; always False otherwise.
        """
        return self._sanitize and self._owner == threading.get_ident()

    # -- core --------------------------------------------------------------
    def get(self, key: Hashable, default: Any = None) -> Any:
        """Lookup + recency bump; counts a hit or a miss."""
        with self._locked():
            try:
                val = self._data[key]
            except KeyError:
                self._misses += 1
                return default
            self._data.move_to_end(key)
            self._hits += 1
            return val

    def insert(self, key: Hashable, value: Any) -> Any:
        """Insert (or adopt an existing entry) and evict past capacity.

        Returns the cached value for ``key``: the existing one if
        another thread inserted first (first insert wins), else
        ``value``.
        """
        with self._locked():
            existing = self._data.get(key)
            if existing is not None:
                self._data.move_to_end(key)
                return existing
            self._data[key] = value
            self._insertions += 1
            while len(self._data) > self._capacity:
                self._data.popitem(last=False)
                self._evictions += 1
            return value

    def get_or_create(self, key: Hashable, factory: Callable[[], Any]) -> Any:
        """Hit, or run ``factory`` (unlocked) and insert its result."""
        with self._locked():
            try:
                val = self._data[key]
            except KeyError:
                self._misses += 1
            else:
                self._data.move_to_end(key)
                self._hits += 1
                return val
        # outside the lock: planning concurrently for *different* keys
        # must not serialize; a same-key race is resolved by insert()
        # (first in wins, loser adopts)
        if self.holds_lock():
            raise InvariantViolation(
                "lock-discipline",
                f"cache {self.name!r}: get_or_create factory would run "
                f"while the calling thread still holds this cache's "
                f"lock — planning under the cache lock serializes every "
                f"request; call get_or_create outside the lock scope",
                subject=self.name,
            )
        return self.insert(key, factory())

    def pop(self, key: Hashable, default: Any = None) -> Any:
        """Remove and return an entry (``default`` when absent).

        Deliberate retirement (a structure was rewritten in place by a
        delta update), not capacity pressure: it does not count as an
        eviction and touches no metric counters.
        """
        with self._locked():
            return self._data.pop(key, default)

    def purge(self, predicate: Callable[[Hashable], bool]) -> int:
        """Drop every entry whose *key* satisfies ``predicate``.

        Returns the number of entries removed.  Like :meth:`pop`, a
        purge is retirement, not eviction: the metrics only track
        capacity behavior.
        ``predicate`` runs under the lock: keep it cheap and never have
        it re-enter the cache.
        """
        with self._locked():
            doomed = [k for k in self._data if predicate(k)]
            for k in doomed:
                del self._data[k]
            return len(doomed)

    # -- introspection / management ---------------------------------------
    def __len__(self) -> int:
        with self._locked():
            return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        with self._locked():
            return key in self._data

    def info(self) -> dict:
        """Size/capacity plus the hit/miss/eviction/insertion counters.

        In sanitize mode two extra keys report the lock sanitizer's
        observations (``lock_sanitize``, ``lock_reentries``).
        """
        with self._locked():
            out = {
                "size": len(self._data),
                "capacity": self._capacity,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "insertions": self._insertions,
            }
            if self._sanitize:
                out["lock_sanitize"] = True
                out["lock_reentries"] = self._reentries
            return out

    def resize(self, capacity: int) -> None:
        """Change capacity; evicts LRU-first if shrinking below size."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._locked():
            self._capacity = capacity
            while len(self._data) > self._capacity:
                self._data.popitem(last=False)
                self._evictions += 1

    def clear(self) -> None:
        """Drop all entries and reset the metric counters."""
        with self._locked():
            self._data.clear()
            self._hits = self._misses = 0
            self._evictions = self._insertions = 0
