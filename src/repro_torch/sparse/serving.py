"""Serving-scale plan service: CUDA-graph executables + warm restarts.

Counterpart of ``repro/sparse/serving.py``.  The paper's §2.3 thesis
(run the expensive symbolic analysis once, replay the cheap numeric
fill many times) becomes cache infrastructure at serving scale: a
process handling concurrent request streams must (a) share symbolic
plans across threads without corruption, (b) stop paying host dispatch
per request once a structure is hot, and (c) come back warm after a
restart.  This module is that layer, between the plan/fill core and
callers:

* **One locked cache core** (:mod:`repro_torch.sparse.lru`): the
  ``sparse2`` plan LRU, the SpGEMM product LRU and the executable tier
  below all ride the same thread-safe, metrics-instrumented LRU.
* **Executable tier**: per hot structure, the numeric phase is captured
  **once** as a ``torch.cuda.CUDAGraph`` and replayed for every
  request: the request's tensors are copied into the graph's static
  inputs, the graph is replayed, and a clone of its static output is
  returned (a later replay never overwrites a returned result).  The
  captured code is exactly what the uncached paths run: the fill
  through ``SparsePattern.scatter`` (B3' for ``sum``/``mean``, B4 for
  ``min``/``max``), ``ProductPattern.multiply`` (B6) and the per-format
  SpMV of :func:`repro_torch.sparse.ops.spmv_impl` (B9 + the row scatter
  for SymCSC, B10 for BSR), so a replay gives the uncached call's result.
  On the CPU the same paths run eagerly, with no graph; every count is
  kept the same way.  On the card a capture that fails raises: nothing
  falls back to an eager call.
* **Persistent warm restarts**: plan and product entries are written
  through to ``cache_dir`` (one pickle of the exact cache key and the
  plan with its tensors as numpy arrays) and loaded back, onto the
  device their key names, on construction, so a restarted server
  re-plans nothing.  A CUDA graph cannot be persisted: a restarted
  server captures each hot structure again on its first request.
* **Request batching**: :meth:`PlanService.assemble_many` groups
  same-structure requests and replays one graph of B fills over a
  stacked ``[B, L]`` static input per group.

Executables freeze the primal computation only: take gradients through
``pattern.assemble``/``ops`` (the autograd path), not through a replay.

Threads: captures run under one process-wide lock, with
``capture_error_mode="thread_local"`` so another thread's uncaptured
work (a plan on a miss) cannot invalidate a capture.  Each executable
has a lock of its own around copy-in, replay and clone-out: one graph
per entry, not one per thread, because a graph's private memory pool
holds its static buffers (tens to hundreds of MB at the paper's sizes)
and the lock is held only while the work is enqueued, not while it
runs.  Callers on different streams are ordered by an event the entry
records after each clone.

    >>> import numpy as np, tempfile
    >>> from repro_torch.sparse.serving import PlanService
    >>> from repro_torch.sparse import plan_cache_clear
    >>> plan_cache_clear()
    >>> svc = PlanService(cache_dir=tempfile.mkdtemp(), device="cpu")
    >>> S = svc.assemble([3, 2, 3], [1, 2, 1], [7.0, 9.0, 1.0])  # cold
    >>> S2 = svc.assemble([3, 2, 3], [1, 2, 1], [2.0, 2.0, 2.0])  # warm
    >>> info = svc.stats()["plan"]
    >>> info["misses"], info["hits"]
    (1, 1)
    >>> plan_cache_clear()                    # "restart" the process
    >>> svc2 = PlanService(cache_dir=svc.cache_dir, device="cpu")
    >>> svc2.loaded_plans                     # warm: plan read from disk
    1
    >>> S3 = svc2.assemble([3, 2, 3], [1, 2, 1], [7.0, 9.0, 1.0])
    >>> svc2.stats()["plan"]["misses"]        # no re-planning
    0
    >>> bool(torch.equal(S3.data, S.data))
    True
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import pickle
import threading
import warnings
import weakref
from pathlib import Path

import numpy as np
import torch

from ..core.csc import CSC
from ..kernels.common import resolve_device
from . import tuning
from .analysis.invariants import maybe_validate_pattern, validate_pattern
from .errors import CacheCorruptionWarning, InvariantViolation
from .formats import convert
from .lru import LRUCache
from .matlab import _PLAN_CACHE, plan_cache_info, plan_lookup, plan_update
from .ops import matmul as _ops_matmul, spmv_impl
from .pattern import SparsePattern
from .spgemm import (_PRODUCT_CACHE, ProductPattern, _structure_key,
                     product_cache_info, product_lookup)

__all__ = [
    "PlanService",
    "apply_runtime_env",
    "enable_compilation_cache",
    "load_caches",
    "runtime_env",
    "save_caches",
    "tcmalloc_hint",
]

#: numeric (re-bindable) fields per flat compressed format, keyed by
#: class name; every other format runs the ordinary ``ops.matmul``
#: dispatch in :meth:`PlanService.spmv`
_SPMV_NUMERIC_FIELDS = {
    "CSC": ("data",),
    "CSR": ("data",),
    "BSR": ("data",),
    "SymCSC": ("diag", "data"),
}


# ---------------------------------------------------------------------------
# Serving runtime environment
# ---------------------------------------------------------------------------
_TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def runtime_env() -> dict:
    """Recommended environment for a serving process.

    Silences tcmalloc's large-allocation reports (plan arrays routinely
    cross its default threshold).  The reference also pins XLA's flags
    and TF's log level; PyTorch reads neither, so they have no
    counterpart here.  Nothing here changes numerics: a replay must
    stay bit-identical to fresh dispatch.
    """
    return {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}


def apply_runtime_env() -> dict:
    """Apply :func:`runtime_env` to ``os.environ`` (non-destructively).

    A variable is only set when absent, so user-provided values survive.
    Returns the mapping of variables actually changed.
    """
    applied = {}
    for var, val in runtime_env().items():
        if var not in os.environ:
            os.environ[var] = val
            applied[var] = val
    return applied


def tcmalloc_hint() -> str | None:
    """``LD_PRELOAD`` line for tcmalloc, if installed but not loaded.

    Preloading cannot be done from inside a running process, so this is
    a hint for the launcher (print it, or export it in the wrapper
    script); returns ``None`` when tcmalloc is already preloaded or not
    installed.
    """
    preload = os.environ.get("LD_PRELOAD", "")
    if "tcmalloc" in preload:
        return None
    for path in _TCMALLOC_PATHS:
        if os.path.exists(path):
            return f"LD_PRELOAD={path}"
    return None


def enable_compilation_cache(path) -> bool:
    """The reference points JAX's persistent compilation cache at
    ``path``.  A CUDA graph holds device pointers of one process and
    cannot be persisted, and the kernels' libraries are already cached
    by content (``build/repro_torch``), so there is nothing to point:
    returns ``False`` (the cache directory was not taken)."""
    return False


# ---------------------------------------------------------------------------
# Persistent plan/product cache entries
# ---------------------------------------------------------------------------
_PICKLE_PROTOCOL = 4  # fixed so digests are stable across interpreters


def _entry_digest(key) -> str:
    """Stable filename digest of a cache key (keys are bytes/str/int
    tuples, so their pickling is deterministic at a fixed protocol)."""
    raw = pickle.dumps(key, protocol=_PICKLE_PROTOCOL)
    return hashlib.sha256(raw).hexdigest()[:32]


def _host_tree(tree):
    """A plan with every tensor field as a CPU numpy array (nested
    dataclasses too: a ``ProductPattern``'s ``pattern``)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _host_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _device_tree(tree, device):
    """The inverse of :func:`_host_tree`: numpy fields back to tensors
    on ``device``."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _device_tree(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree


def _key_device(kind: str, key) -> str:
    """The device a cache key names: the plan key's (its last element
    but one, ``matlab._cache_key``), or the first operand's structure
    key's (its last, ``spgemm._structure_key``) for a product."""
    return key[-2] if kind == "plan" else key[0][-1]


def _entry_path(cache_dir: Path, kind: str, key) -> Path:
    return Path(cache_dir) / f"{kind}-{_entry_digest(key)}.pkl"


def _write_entry(cache_dir: Path, kind: str, key, value) -> Path:
    """Atomically persist one cache entry (exact key + host plan)."""
    path = _entry_path(cache_dir, kind, key)
    if path.exists():
        return path
    payload = {"kind": kind, "key": key, "value": _host_tree(value)}
    tmp = path.with_suffix(f".tmp.{os.getpid()}.{threading.get_ident()}")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=_PICKLE_PROTOCOL)
    os.replace(tmp, path)  # atomic: concurrent writers race benignly
    return path


def save_caches(cache_dir) -> int:
    """Persist every in-memory plan/product cache entry to ``cache_dir``.

    Only :class:`SparsePattern` and :class:`ProductPattern` entries are
    persisted (a ``format="symcsc"`` plan, a ``SymPattern``, and a
    sharded plan, which carries its mesh, are re-planned per process, as
    in the reference).  Returns the number of
    entries on disk afterwards that this call wrote or refreshed.
    """
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    written = 0
    for kind, cache, types in (
        ("plan", _PLAN_CACHE, (SparsePattern,)),
        ("product", _PRODUCT_CACHE, (ProductPattern,)),
    ):
        for key, value in cache.items():
            if isinstance(value, types):
                _write_entry(cache_dir, kind, key, value)
                written += 1
    return written


def load_caches(cache_dir) -> tuple:
    """Load persisted entries back into the in-memory caches.

    Returns ``(plans, products)`` counts.  Each entry's tensors go to
    the device its key names.  Corrupt or unreadable files are skipped
    with a :class:`~repro_torch.sparse.errors.CacheCorruptionWarning`:
    a damaged cache entry must degrade to a re-plan, never to a crash.
    Every entry that *does* unpickle is run through the structural
    validators (:mod:`repro_torch.sparse.analysis.invariants`) before
    insertion, unconditionally: a tampered pickle that still
    deserializes is detected by the invariant it breaks, not served.
    """
    cache_dir = Path(cache_dir)
    counts = {"plan": 0, "product": 0}
    if not cache_dir.is_dir():
        return (0, 0)
    targets = {"plan": _PLAN_CACHE, "product": _PRODUCT_CACHE}
    expected = {"plan": SparsePattern, "product": ProductPattern}
    for path in sorted(cache_dir.glob("*.pkl")):
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
            kind = payload["kind"]
            if not isinstance(payload["value"], expected[kind]):
                raise InvariantViolation(
                    "entry-schema",
                    f"{kind} entry holds a "
                    f"{type(payload['value']).__name__}, expected "
                    f"{expected[kind].__name__}",
                    subject=path.name,
                )
            value = _device_tree(payload["value"],
                                 _key_device(kind, payload["key"]))
            validate_pattern(value, subject=path.name)
            targets[kind].insert(payload["key"], value)
            counts[kind] += 1
        except InvariantViolation as e:
            warnings.warn(
                f"skipping invalid plan-cache entry {path.name}: {e}",
                CacheCorruptionWarning,
                stacklevel=2,
            )
        except Exception as e:  # noqa: BLE001 - degrade to re-plan
            warnings.warn(
                f"skipping unreadable plan-cache entry {path.name}: "
                f"{type(e).__name__}: {e}",
                CacheCorruptionWarning,
                stacklevel=2,
            )
    return (counts["plan"], counts["product"])


# ---------------------------------------------------------------------------
# The executable tier: one CUDA graph per entry
# ---------------------------------------------------------------------------
#: one capture at a time in the process: captures share the allocator's
#: capture bookkeeping, and a failed one must not interleave with another
_CAPTURE_LOCK = threading.Lock()


class GraphCounts:
    """Captures and replays per executable kind, under a lock.

    The kernels' launch counters count Python calls of their wrappers:
    a capture bumps them once and a replay not at all, so the tier keeps
    counts of its own.  On the CPU a "capture" is the build of an eager
    entry and a "replay" one call of it, so the counts read the same.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.captures: collections.Counter = collections.Counter()
        self.replays: collections.Counter = collections.Counter()

    def note(self, which: str, kind: str) -> None:
        with self._lock:
            getattr(self, which)[kind] += 1

    def info(self) -> dict:
        with self._lock:
            return {"captures": dict(self.captures),
                    "replays": dict(self.replays)}


class Executable:
    """``fn`` over tensor inputs, captured once as a CUDA graph.

    ``inputs`` are the first request's tensors, which fix the shapes and
    dtypes.  On CUDA they are copied into static inputs, ``fn`` runs
    once eagerly on a side stream (first-use work such as a library's
    load or ``cudaFuncSetAttribute`` stays out of the graph), then once
    under capture; a capture that fails raises.  For CPU inputs ``fn``
    runs eagerly on every call and no graph exists.  ``fn`` returns one
    tensor; a call returns a clone of the graph's.
    """

    def __init__(self, fn, inputs, *, kind: str = "fn",
                 counts: GraphCounts | None = None):
        self.fn = fn
        self.kind = kind
        self.counts = counts
        self.graph = None
        self._lock = threading.Lock()
        device = inputs[0].device
        if device.type == "cuda":
            self._capture(inputs, device)
        if counts is not None:
            counts.note("captures", kind)

    def _capture(self, inputs, device) -> None:
        with _CAPTURE_LOCK, torch.no_grad():
            current = torch.cuda.current_stream(device)
            self.static_in = [x.clone() for x in inputs]
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                self.fn(*self.static_in)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.static_out = self.fn(*self.static_in)
                finally:
                    graph.capture_end()
            current.wait_stream(side)
            self.device = device
            self._done = torch.cuda.Event()
            self.graph = graph

    def __call__(self, *inputs):
        if self.counts is not None:
            self.counts.note("replays", self.kind)
        if self.graph is None:
            with torch.no_grad():
                return self.fn(*inputs)
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._done)  # no-op before the first record
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
            self.graph.replay()
            out = self.static_out.clone()
            self._done.record(stream)
        return out


class _IdentityMemo:
    """Values memoised per object identity.

    An entry is found by the identity of ``objs[0]`` and used only while
    every object of ``objs`` is the one it was made for (weak references)
    and ``stamp`` is unchanged; it is dropped when ``objs[0]`` is freed.
    The service keys its requests through it: a key holds a structure's
    bytes, and building one copies the structure to the host, while
    comparing two equal keys that are distinct objects reads all their
    bytes; a memoised key is built once and compared by identity.
    """

    def __init__(self):
        # re-entrant: ``drop`` runs when an object dies, which a garbage
        # collection can make happen inside ``get``'s locked region
        self._lock = threading.RLock()
        self._memo: dict = {}

    def get(self, objs: tuple, stamp, compute):
        ident = id(objs[0])
        with self._lock:
            hit = self._memo.get(ident)
        if hit is not None:
            refs, hit_stamp, value = hit
            if hit_stamp == stamp and all(
                    r() is o for r, o in zip(refs, objs)):
                return value
        value = compute()

        def drop(ref):
            with self._lock:
                if self._memo.get(ident, ((None,),))[0][0] is ref:
                    del self._memo[ident]

        refs = (weakref.ref(objs[0], drop),
                *(weakref.ref(o) for o in objs[1:]))
        with self._lock:
            self._memo[ident] = (refs, stamp, value)
        return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._memo)


def _memo_structure_key(memo: _IdentityMemo, S) -> tuple:
    """:func:`_structure_key` of ``S`` through ``memo``: found by the
    ``indices`` tensor, used while ``indices`` and ``indptr`` are the
    same tensors with the same ``_version`` (an in-place write bumps it)
    and ``S`` has the same shape."""
    ind, ptr = S.indices, S.indptr
    return memo.get((ind, ptr), (ind._version, ptr._version,
                                 tuple(S.shape)),
                    lambda: _structure_key(S))


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------
class PlanService:
    """Thread-safe serving front end over the plan/fill core.

    One instance per serving process.  Symbolic plans are shared with
    (and served from) the global ``sparse2``/SpGEMM LRUs, so existing
    ``sparse2``/``ops.matmul`` callers and the service warm each other,
    while the executable tier is per service (graphs bind to this
    process's device memory).

    On a group of ranks (``launch.ranks.init_ranks``) each rank runs its
    own service and every rank makes the same requests in the same
    order: a ``method="sharded"`` request plans and fills on the rank
    mesh (each rank its own block, its own fill), ``spmv`` of the
    ``ShardedCSC`` it returns runs the sharded SpMV (a collective), and
    the plans the services persist to one ``cache_dir`` are written by
    atomic replace, so several ranks may write the same entry.

    Parameters
    ----------
    cache_dir:
        Optional persistence root.  When set, plan/product entries are
        written through on first use and loaded back on construction
        (``loaded_plans``/``loaded_products`` report how many), and the
        measured tuning table persists beside them.
    exec_capacity:
        Executable-tier LRU capacity (env override:
        ``REPRO_EXEC_CACHE_SIZE``).  An evicted entry's graph and its
        static buffers are freed with it.
    donate:
        Kept from the reference, where it donates request buffers to the
        executables; here a request's tensors are copied into the
        graph's static inputs and never aliased, so it changes nothing.
        Default: on for a CUDA service, off on the CPU (as the
        reference's default follows its backend).
    method:
        Default planning backend for requests (same contract as
        ``fsparse(..., method=)``); per-call ``method=`` overrides.
    device:
        Where plans, fills and graphs live: ``"cuda"`` unless the caller
        passes another; with no card and no ``device="cpu"`` it raises.
    """

    def __init__(self, *, cache_dir=None, exec_capacity: int = 64,
                 donate: bool | None = None, method: str | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.method = method
        self.donate = (self.device.type == "cuda" if donate is None
                       else bool(donate))
        self._execs = LRUCache(exec_capacity, name="aot-exec",
                               env="REPRO_EXEC_CACHE_SIZE")
        self._graphs = GraphCounts()
        # structure keys per index tensor, canonical plan keys and entry
        # digests per plan object (see _IdentityMemo)
        self._structure_memo = _IdentityMemo()
        self._plan_memo = _IdentityMemo()
        self._digest_memo = _IdentityMemo()
        self._persisted: set = set()
        self._persist_lock = threading.Lock()
        self.cache_dir = None
        self.loaded_plans = 0
        self.loaded_products = 0
        self.loaded_tuning_entries = 0
        if cache_dir is not None:
            self.cache_dir = Path(cache_dir)
            self.cache_dir.mkdir(parents=True, exist_ok=True)
            self.loaded_plans, self.loaded_products = load_caches(
                self.cache_dir
            )
            # the measured tuning table persists alongside the plan
            # caches: a restarted server resumes with the same policies
            # (and therefore the same executable keys) it tuned before
            table_path = self.cache_dir / tuning.TABLE_FILENAME
            if table_path.is_file():
                self.loaded_tuning_entries = tuning.get_table().load(
                    table_path
                )

    # -- persistence -------------------------------------------------------
    def _structure_keys(self, S) -> tuple:
        return _memo_structure_key(self._structure_memo, S)

    def _plan_key(self, key, pat):
        """The first key this service saw for the plan object ``pat``:
        equal to ``key`` (the plan LRU holds one plan a key), and the
        object the executable tier's keys were built from."""
        return self._plan_memo.get((pat,), None, lambda: key)

    def _persist(self, kind: str, key, value) -> None:
        if self.cache_dir is None:
            return
        digest = (kind, self._digest_memo.get(
            (value,), None, lambda: _entry_digest(key)))
        with self._persist_lock:
            if digest in self._persisted:
                return
            self._persisted.add(digest)
        try:
            _write_entry(self.cache_dir, kind, key, value)
        except Exception as e:  # noqa: BLE001 - serving must not crash
            warnings.warn(
                f"could not persist {kind} cache entry: "
                f"{type(e).__name__}: {e}",
                CacheCorruptionWarning,
                stacklevel=2,
            )

    def save(self) -> int:
        """Flush every in-memory plan/product entry to ``cache_dir``
        (plus the tuning table when it holds measured entries)."""
        if self.cache_dir is None:
            raise ValueError("PlanService has no cache_dir to save into")
        table = tuning.get_table()
        if len(table):
            table.save(self.cache_dir / tuning.TABLE_FILENAME)
        return save_caches(self.cache_dir)

    def _retire_persisted(self, old_key, old_structure_key) -> None:
        """Drop on-disk entries for a structure rewritten by an update.

        The plan entry is addressed directly by its key; product entries
        are keyed on *both* operands' structure keys, so the on-disk
        product files are scanned and any whose key references the
        retired structure is unlinked.  All best-effort: a stale file
        that survives only costs one wasted load on the next restart
        (the in-memory caches were already purged).
        """
        if self.cache_dir is None:
            return
        with self._persist_lock:
            self._persisted.discard(("plan", _entry_digest(old_key)))
        try:
            _entry_path(self.cache_dir, "plan", old_key).unlink(
                missing_ok=True)
        except OSError:
            pass
        for path in self.cache_dir.glob("product-*.pkl"):
            try:
                with open(path, "rb") as f:
                    payload = pickle.load(f)
                k = payload.get("key", ())
                if len(k) >= 2 and old_structure_key in (k[0], k[1]):
                    with self._persist_lock:
                        self._persisted.discard(
                            ("product", _entry_digest(payload["key"])))
                    path.unlink(missing_ok=True)
            except Exception:  # noqa: BLE001 - stale file, not a crash
                pass

    # -- executable tier ---------------------------------------------------
    def _aot(self, ekey, make_fn, inputs):
        """The executable of ``ekey``; on a miss, ``make_fn()`` is
        captured over the request's ``inputs``."""
        # the tuning fingerprint is folded into every executable key: a
        # re-tune (new measured table) retires graphs captured under the
        # old policy instead of replaying them
        return self._execs.get_or_create(
            ekey + (tuning.tuning_fingerprint(),),
            lambda: Executable(make_fn(), inputs, kind=ekey[0],
                               counts=self._graphs),
        )

    def _fill(self, key, pat: SparsePattern, vals: torch.Tensor):
        """One fill of ``vals`` through the plan's executable: the
        captured :meth:`SparsePattern.scatter`."""
        ekey = ("fill", self._plan_key(key, pat), str(vals.dtype), None)
        return self._aot(ekey, lambda: pat.scatter, (vals,))(vals)

    # -- request API -------------------------------------------------------
    def assemble(self, ii, jj, ss, shape=None, nzmax: int | None = None,
                 *, method: str | None = None, accum: str = "sum") -> CSC:
        """Matlab-style assembly served from the plan + executable caches.

        Same contract and bit-identical results as
        :func:`repro_torch.sparse.fsparse`; a hot structure pays the
        host facade and one replay of the captured fill.
        """
        key, pat, vals = plan_lookup(
            ii, jj, ss, shape, nzmax,
            method=self.method if method is None else method, accum=accum,
            device=self.device,
        )
        if not isinstance(pat, SparsePattern):
            # a sharded plan runs its own fill (no graph: an executable
            # would pin one mesh layout per entry; not persisted)
            return pat.assemble(vals)
        maybe_validate_pattern(pat, subject="PlanService.assemble")
        self._persist("plan", key, pat)
        return self._wrap(pat, self._fill(key, pat, vals))

    def assemble_many(self, requests, *, method: str | None = None,
                      accum: str = "sum") -> list:
        """Batched front end: one executable per structure group.

        ``requests`` is an iterable of ``(ii, jj, ss)`` or
        ``(ii, jj, ss, shape)`` tuples from independent streams.  The
        requests are grouped by structure identity and value dtype; a
        group of size B > 1 is served by one graph of B fills over a
        stacked ``[B, L]`` static input, and the results come back in
        request order, bit-identical to per-request :meth:`assemble`.
        """
        looked = []
        for req in requests:
            ii, jj, ss = req[0], req[1], req[2]
            shape = req[3] if len(req) > 3 else None
            looked.append(plan_lookup(
                ii, jj, ss, shape,
                method=self.method if method is None else method,
                accum=accum, device=self.device,
            ))
        groups: dict = {}
        for idx, (key, _, vals) in enumerate(looked):
            groups.setdefault((key, str(vals.dtype)), []).append(idx)
        results: list = [None] * len(looked)
        for (key, dtype), idxs in groups.items():
            pat = looked[idxs[0]][1]
            if not isinstance(pat, SparsePattern):
                for i in idxs:
                    results[i] = pat.assemble(looked[i][2])
                continue
            self._persist("plan", key, pat)
            if len(idxs) == 1:
                results[idxs[0]] = self._wrap(
                    pat, self._fill(key, pat, looked[idxs[0]][2]))
                continue
            stacked = torch.stack([looked[i][2] for i in idxs])
            ekey = ("fill", self._plan_key(key, pat), dtype, len(idxs))
            data_b = self._aot(
                ekey, lambda: lambda v: pat.assemble_batch(v).data,
                (stacked,))(stacked)
            for b, i in enumerate(idxs):
                results[i] = self._wrap(pat, data_b[b])
        return results

    def update_structure(self, ii, jj, ss, add_ii, add_jj, add_ss,
                         shape=None, nzmax: int | None = None, *,
                         drop_mask=None, method: str | None = None,
                         accum: str = "sum",
                         nzmax_slack: int = 0) -> CSC:
        """Absorb a structural delta without cold-starting the structure.

        Runs :func:`repro_torch.sparse.plan_update` (merge-forward delta
        re-planning through the shared plan LRU, B7 on the card,
        uncaptured), then reconciles the serving tiers: executables
        bound to the *old* structure (its fill, and any multiply or
        SpMV over its index arrays) are retired from the executable
        LRU, persisted entries for the old structure are unlinked from
        ``cache_dir``, and only the updated structure's fill is
        captured.  Executables of unrelated structures are untouched.

        Returns the assembled updated matrix (bit-identical to a cold
        :meth:`assemble` over the concatenated surviving + delta
        triplets).
        """
        res = plan_update(
            ii, jj, ss, add_ii, add_jj, add_ss, shape, nzmax,
            drop_mask=drop_mask,
            method=self.method if method is None else method,
            accum=accum, nzmax_slack=nzmax_slack, device=self.device,
        )
        if res.pattern is not res.old_pattern:
            old_sk = self._structure_keys(res.old_pattern)

            def _stale(ekey) -> bool:
                kind = ekey[0]
                if kind == "fill":
                    return ekey[1] == res.old_key
                if kind == "multiply":
                    return old_sk in (ekey[1][0], ekey[1][1])
                if kind == "spmv":
                    return ekey[2] == old_sk
                return False

            self._execs.purge(_stale)
            self._retire_persisted(res.old_key, old_sk)
        maybe_validate_pattern(res.pattern,
                               subject="PlanService.update_structure")
        self._persist("plan", res.key, res.pattern)
        return self._wrap(res.pattern,
                          self._fill(res.key, res.pattern, res.coo.vals))

    def multiply(self, A, B, *, method: str | None = None,
                 nzmax: int | None = None,
                 flops_max: int | None = None) -> CSC:
        """Sparse x sparse product through cached plan + executable.

        Same results as ``ops.matmul(A, B)``; the symbolic product plan
        comes from the shared SpGEMM LRU (and is persisted), the
        O(flops) numeric refill (B6) from a captured graph.
        """
        Ac = convert(A, "csc")
        Bc = convert(B, "csc")
        key, pp = product_lookup(Ac, Bc, method=method, nzmax=nzmax,
                                 flops_max=flops_max,
                                 structure_key=self._structure_keys)
        maybe_validate_pattern(pp, subject="PlanService.multiply")
        self._persist("product", key, pp)
        ekey = ("multiply", key, str(Ac.data.dtype), str(Bc.data.dtype))
        data = self._aot(ekey, lambda: lambda a, b: pp.multiply(a, b).data,
                         (Ac.data, Bc.data))(Ac.data, Bc.data)
        return self._wrap(pp.pattern, data)

    def spmv(self, S, x):
        """``S @ x`` (dense vector/matrix) via a per-structure executable.

        The per-format dispatch (:func:`repro_torch.sparse.ops.spmv_impl`)
        is resolved once, at capture, over a copy of the structure's
        index arrays; each request rebinds only the numeric fields.  A
        2-D ``x`` is captured as its columns, one after the other.
        Formats without a flat column/row-compressed structure run the
        ordinary ``ops.matmul`` dispatch.  The structure's key is
        memoised per index tensor (:class:`_IdentityMemo`), so a hit
        copies nothing to the host.
        """
        x = torch.as_tensor(x)
        if x.ndim not in (1, 2):
            raise ValueError(
                f"spmv expects a vector or matrix, got ndim={x.ndim}"
            )
        fn, Sr = spmv_impl(S)
        fields = _SPMV_NUMERIC_FIELDS.get(type(Sr).__name__)
        if fields is None or not hasattr(Sr, "indices"):
            return _ops_matmul(Sr, x)
        nums = tuple(getattr(Sr, f) for f in fields)
        ekey = ("spmv", type(Sr).__name__, self._structure_keys(Sr),
                tuple(str(n.dtype) for n in nums),
                getattr(Sr, "block", None), tuple(x.shape), str(x.dtype))

        def build():
            # the graph reads its own copy of the structure: a later
            # in-place write to the caller's index arrays re-keys the
            # caller's requests and leaves this entry's structure alone
            bound = dataclasses.replace(Sr, **{
                f.name: getattr(Sr, f.name).clone()
                for f in dataclasses.fields(Sr)
                if f.name not in fields
                and isinstance(getattr(Sr, f.name), torch.Tensor)})

            def f(*args):
                *vals, xv = args
                A = dataclasses.replace(bound, **dict(zip(fields, vals)))
                if xv.ndim == 1:
                    return fn(A, xv)
                return torch.stack([fn(A, xv[:, j])
                                    for j in range(xv.shape[1])], dim=1)

            return f

        return self._aot(ekey, build, (*nums, x))(*nums, x)

    # -- introspection -----------------------------------------------------
    @staticmethod
    def _wrap(pat: SparsePattern, data) -> CSC:
        return CSC(data=data, indices=pat.indices, indptr=pat.indptr,
                   nnz=pat.nnz, shape=pat.shape)

    def stats(self) -> dict:
        """All cache tiers' metrics in one dict (the ops dashboard).

        The reference's keys, plus ``graphs`` (captures and replays per
        executable kind: the kernels' launch counters do not see a
        replay), ``graph_mode`` (``"cuda-graph"``, or ``"eager"`` on the
        CPU) and ``device``.
        """
        return {
            "plan": plan_cache_info(),
            "product": product_cache_info(),
            "exec": self._execs.info(),
            "graphs": self._graphs.info(),
            "graph_mode": "cuda-graph" if self.device.type == "cuda"
            else "eager",
            "device": str(self.device),
            "loaded_plans": self.loaded_plans,
            "loaded_products": self.loaded_products,
            "loaded_tuning_entries": self.loaded_tuning_entries,
            "tuning_fingerprint": tuning.tuning_fingerprint(),
            "persisted": len(self._persisted),
            "cache_dir": None if self.cache_dir is None
            else str(self.cache_dir),
            "donate": self.donate,
        }
