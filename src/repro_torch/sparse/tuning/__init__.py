"""Unified execution-policy layer: the tunables registry + autotune cache.

Counterpart of ``repro/sparse/tuning/__init__.py``.  Every kernel family
registers a declarative :class:`KernelSpec` naming its knobs with the
values the port runs today as *priors*; a :class:`TuningTable` overlays
measured entries per ``(backend, family, M, N, L, dtype)``, most
specific last, and persists as schema-1 JSON (``tuning-table.json``;
a corrupt file degrades to the priors with a
:class:`~repro_torch.sparse.errors.CacheCorruptionWarning`).

The backend of a resolution is the device of the tensors it serves:
``"cuda"`` or ``"cpu"`` (:func:`backend_of`); ``backend=None`` is the
port's default device, CUDA, as in
:func:`repro_torch.kernels.common.resolve_device`.  The priors are the
H100 ones the port measured or fixed, never a TPU value.

Two kinds of knob:

* *runtime* knobs are values the Python wrappers pass or branch on (the
  plan and merge methods, the radix digit width, B12's block range, B7's
  and B9's shape thresholds); they carry the candidates
  ``python -m repro_torch.sparse.tuning --measure`` sweeps.  A method
  knob names the values that run a hand-written kernel on the card
  (``Knob.allowed``): a table may steer a CUDA call only among them,
  never to a plain version;
* *build-time* knobs (``build=True``) are what a ``.cu`` file fixes with
  ``constexpr`` (tiles, threads a block, resident blocks an SM).  They
  are registered with the build's value as prior and no candidates; the
  wrappers check each library's exported value against them at load,
  and a table cannot override them (changing one means rebuilding the
  kernel).

The reference's ``RESIDENT_BUDGET_BYTES`` (an 8 MB VMEM residency cap)
has no counterpart: every CUDA kernel reads its operands from device
memory and serves every size.

Each family declares the size axes its call site resolves at
(``KernelSpec.axes``, e.g. ``counting_sort``: ``N`` bins, ``L`` keys); a
record or a resolution on another axis raises, so a measured entry is
keyed as its call site looks it up.

Resolution is memoised per ``(table, family, backend, M/N/L bucket,
dtype)`` (the port resolves on every eager call, not once per trace);
any change of a table or the registry clears the memo.

Environment knobs: ``REPRO_TUNE=0`` disables measured overrides (priors
only); ``REPRO_TUNING_CACHE_DIR`` names a directory whose
``tuning-table.json`` is loaded into the process-global table on first
use.

    >>> resolve_policy("plan", backend="cuda", measured=False)["method"]
    'radix'
    >>> resolve_policy("plan", backend="cpu", measured=False)["method"]
    'fused'
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import warnings
from pathlib import Path

import numpy as np

from ..errors import CacheCorruptionWarning

__all__ = [
    "Knob",
    "KernelSpec",
    "TABLE_FILENAME",
    "TuningTable",
    "backend_of",
    "build_knobs",
    "default_cache_path",
    "get_table",
    "kernel_spec",
    "prior_policy",
    "prior_value",
    "register_kernel_spec",
    "registered_families",
    "reset_table",
    "resolve_policy",
    "set_table",
    "tuning_enabled",
    "tuning_fingerprint",
]

#: filename of a persisted table inside a cache directory
TABLE_FILENAME = "tuning-table.json"

#: on-disk schema version (the reference's)
_SCHEMA = 1


def backend_of(where=None) -> str:
    """The backend key of a device, a tensor or a backend name:
    ``"cuda"`` or ``"cpu"``; ``None`` is the port's default device,
    CUDA (``resolve_device``'s choice)."""
    if where is None:
        return "cuda"
    if isinstance(where, str):
        return where.split(":")[0]
    dev = getattr(where, "device", where)
    return getattr(dev, "type", str(dev))


def _dtype_name(dtype) -> str | None:
    """``"float32"`` for a torch, numpy or named dtype alike, so one
    schema-1 file keys the same cells in both packages."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        return dtype
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    try:
        return np.dtype(dtype).name
    except TypeError:
        return name


def _bucket(v) -> int | None:
    """Power-of-two size bucket (``bit_length``); ``None`` is wildcard."""
    if v is None:
        return None
    return max(int(v), 1).bit_length()


# ---------------------------------------------------------------------------
# Declarative tunables registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable of a kernel family.

    ``default`` is the prior: a plain value or a backend-keyed dict
    (``{"cuda": "radix", "*": "fused"}``); ``candidates`` is the grid the
    autotuner sweeps (empty: not swept).  ``allowed`` maps a backend to
    the only values a table may give the knob there (the methods that
    launch a hand-written kernel on ``cuda``).  ``build=True`` marks a
    value a ``.cu`` file fixes at compile time: never swept, never
    overridden.
    """

    name: str
    default: object
    candidates: tuple = ()
    build: bool = False
    allowed: dict = dataclasses.field(default_factory=dict)

    def prior(self, backend: str | None = None):
        if isinstance(self.default, dict):
            if backend in self.default:
                return self.default[backend]
            return self.default["*"]
        return self.default

    def allows(self, value, backend: str | None) -> bool:
        """Whether a table may set ``value`` on ``backend`` (``None``: an
        entry for every backend, so every backend's rule applies)."""
        rules = self.allowed.values() if backend is None else (
            [self.allowed[backend]] if backend in self.allowed else [])
        return all(value in vals for vals in rules)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A kernel family's declared knob set (with priors) and the size
    axes (of ``M``, ``N``, ``L``) its call site resolves at."""

    family: str
    knobs: tuple
    description: str = ""
    axes: tuple = ("M", "N", "L")

    def check_axes(self, **dims) -> None:
        """Raise unless every size given is on one of the family's axes."""
        bad = sorted(a for a, v in dims.items()
                     if v is not None and a not in self.axes)
        if bad:
            raise ValueError(
                f"kernel family {self.family!r} resolves at {self.axes}, "
                f"not at {tuple(bad)}")

    def knob_names(self) -> tuple:
        return tuple(k.name for k in self.knobs)

    def knob(self, name: str) -> Knob:
        for k in self.knobs:
            if k.name == name:
                return k
        raise KeyError(
            f"kernel family {self.family!r} has no knob {name!r}; "
            f"declared: {self.knob_names()}"
        )

    def priors(self, backend: str | None = None) -> dict:
        return {k.name: k.prior(backend) for k in self.knobs}


_SPECS: dict = {}
_SPECS_LOCK = threading.Lock()


def register_kernel_spec(spec: KernelSpec) -> None:
    """Register (or replace) a kernel family's tunables spec."""
    with _SPECS_LOCK:
        _SPECS[spec.family] = spec
    _invalidate()


def kernel_spec(family: str) -> KernelSpec:
    try:
        return _SPECS[family]
    except KeyError:
        raise KeyError(
            f"unknown kernel family {family!r}; "
            f"registered: {registered_families()}"
        ) from None


def registered_families() -> tuple:
    return tuple(sorted(_SPECS))


def prior_policy(family: str, backend: str | None = None) -> dict:
    """The spec's priors alone: what resolution falls back to."""
    return kernel_spec(family).priors(backend)


def prior_value(family: str, knob: str, backend: str | None = None):
    return kernel_spec(family).knob(knob).prior(backend)


def build_knobs(family: str) -> dict:
    """The family's build-time knobs and their (fixed) values."""
    return {k.name: k.default for k in kernel_spec(family).knobs if k.build}


# ---------------------------------------------------------------------------
# The resolution memo: cleared by any change of a table or the registry
# ---------------------------------------------------------------------------
_MEMO: dict = {}
_MEMO_LOCK = threading.Lock()
#: bumped by every invalidation: a resolution computed across one is not
#: memoised (it may have read the entries before the change)
_GENERATION = [0]


def _invalidate() -> None:
    with _MEMO_LOCK:
        _MEMO.clear()
        _GENERATION[0] += 1


# ---------------------------------------------------------------------------
# The measured table
# ---------------------------------------------------------------------------
_ENTRY_AXES = ("backend", "M_bucket", "N_bucket", "L_bucket", "dtype")


@dataclasses.dataclass
class _Entry:
    family: str
    policy: dict
    backend: str | None = None
    M_bucket: int | None = None
    N_bucket: int | None = None
    L_bucket: int | None = None
    dtype: str | None = None
    source: str = "measured"

    def key(self) -> tuple:
        return (self.family,) + tuple(getattr(self, a) for a in _ENTRY_AXES)

    def specificity(self) -> int:
        return sum(getattr(self, a) is not None for a in _ENTRY_AXES)

    def matches(self, family, backend, mb, nb, lb, dtype) -> bool:
        if self.family != family:
            return False
        for mine, theirs in ((self.backend, backend), (self.M_bucket, mb),
                             (self.N_bucket, nb), (self.L_bucket, lb),
                             (self.dtype, dtype)):
            if mine is not None and mine != theirs:
                return False
        return True

    def as_dict(self) -> dict:
        d = {"family": self.family, "policy": dict(self.policy),
             "source": self.source}
        for a in _ENTRY_AXES:
            if getattr(self, a) is not None:
                d[a] = getattr(self, a)
        return d


class TuningTable:
    """Measured policy overrides over the registry priors.

    Resolution: start from :meth:`KernelSpec.priors` for the backend,
    then overlay every matching measured entry least-specific first: a
    ``(backend, L-bucket)`` entry beats a backend-wide one.  With
    ``measured=False`` (or ``REPRO_TUNE=0``) the priors are returned
    untouched.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: list = []
        _invalidate()  # a new table may reuse a dropped one's id

    # -- recording ---------------------------------------------------------
    def record(self, family: str, policy: dict, *,
               backend: str | None = None, M=None, N=None, L=None,
               dtype=None, source: str = "measured") -> None:
        """Record measured knob overrides for one (family, shape) cell.

        ``policy`` holds only the overridden knobs; unknown families or
        knobs raise ``KeyError`` (the registry is the schema), a
        build-time knob ``ValueError``.  A new record for the same cell
        replaces the old one.
        """
        self._add(_Entry(family=family, policy=dict(policy),
                         backend=None if backend is None
                         else backend_of(backend),
                         M_bucket=_bucket(M), N_bucket=_bucket(N),
                         L_bucket=_bucket(L), dtype=_dtype_name(dtype),
                         source=source))

    def _add(self, entry: _Entry) -> None:
        spec = kernel_spec(entry.family)
        spec.check_axes(M=entry.M_bucket, N=entry.N_bucket,
                        L=entry.L_bucket)
        for name, value in entry.policy.items():
            knob = spec.knob(name)  # KeyError on an unknown knob
            if knob.build:
                raise ValueError(
                    f"knob {name!r} of {entry.family!r} is fixed at build "
                    "time by its .cu source; rebuild the kernel to change it"
                )
            if not knob.allows(value, entry.backend):
                raise ValueError(
                    f"{entry.family}.{name} = {value!r} is not allowed on "
                    f"backend {entry.backend or '*'}: there it must be one "
                    f"of {knob.allowed}")
        with self._lock:
            self._entries = [e for e in self._entries
                             if e.key() != entry.key()]
            self._entries.append(entry)
        _invalidate()

    def clear(self) -> None:
        with self._lock:
            self._entries = []
        _invalidate()

    def entries(self) -> list:
        with self._lock:
            return [e.as_dict() for e in self._entries]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- resolution --------------------------------------------------------
    def resolve(self, family: str, *, backend=None, M=None, N=None, L=None,
                dtype=None, measured: bool = True) -> dict:
        """The effective policy for one kernel invocation (a fresh dict)."""
        backend = backend_of(backend)
        key = (id(self) if measured and tuning_enabled() else None, family,
               backend, _bucket(M), _bucket(N), _bucket(L),
               _dtype_name(dtype))
        hit = _MEMO.get(key)
        if hit is None:
            generation = _GENERATION[0]
            hit = self._resolve(family, backend, key)
            with _MEMO_LOCK:
                if _GENERATION[0] == generation:
                    _MEMO[key] = hit
        return dict(hit)

    def _resolve(self, family: str, backend: str, key: tuple) -> dict:
        _, _, _, mb, nb, lb, dt = key
        spec = kernel_spec(family)
        spec.check_axes(M=mb, N=nb, L=lb)
        policy = spec.priors(backend)
        if key[0] is None:
            return policy
        with self._lock:
            hits = [e for e in self._entries
                    if e.matches(family, backend, mb, nb, lb, dt)]
        for e in sorted(hits, key=_Entry.specificity):
            policy.update(e.policy)
        return policy

    # -- persistence -------------------------------------------------------
    def fingerprint(self) -> str:
        """Content hash of the measured state (stable across processes
        and equal to the reference's for the same entries); ``"prior"``
        for an empty table."""
        with self._lock:
            if not self._entries:
                return "prior"
            blob = json.dumps(sorted(self.entries(), key=json.dumps),
                              sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def save(self, path) -> Path:
        """Atomically persist the table as JSON (``tmp`` + rename)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"schema": _SCHEMA, "fingerprint": self.fingerprint(),
                   "entries": self.entries()}
        tmp = path.with_suffix(f".tmp.{os.getpid()}")
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
        return path

    def load(self, path) -> int:
        """Merge entries from a persisted table; returns how many.

        A corrupt file or a stale schema degrades to the priors with a
        :class:`CacheCorruptionWarning`; individually invalid entries
        (unknown family or knob, a build-time knob) are skipped one by
        one with the same warning.
        """
        path = Path(path)
        try:
            with open(path) as fh:
                payload = json.load(fh)
            if payload.get("schema") != _SCHEMA:
                raise ValueError(
                    f"schema {payload.get('schema')!r} != {_SCHEMA}")
            raw = payload["entries"]
            if not isinstance(raw, list):
                raise TypeError("entries is not a list")
        except Exception as e:  # noqa: BLE001 - degrade to priors
            warnings.warn(
                f"ignoring corrupt tuning table {path}: "
                f"{type(e).__name__}: {e} — resolving from priors",
                CacheCorruptionWarning, stacklevel=2)
            return 0
        loaded = 0
        for rec in raw:
            try:
                # buckets were persisted pre-bucketed: restore verbatim
                self._add(_Entry(
                    family=rec["family"], policy=dict(rec["policy"]),
                    backend=rec.get("backend"),
                    M_bucket=rec.get("M_bucket"),
                    N_bucket=rec.get("N_bucket"),
                    L_bucket=rec.get("L_bucket"), dtype=rec.get("dtype"),
                    source=rec.get("source", "measured")))
                loaded += 1
            except Exception as e:  # noqa: BLE001 - skip bad entry
                warnings.warn(
                    f"skipping invalid tuning entry {rec!r} from {path}: "
                    f"{type(e).__name__}: {e}",
                    CacheCorruptionWarning, stacklevel=2)
        return loaded


# ---------------------------------------------------------------------------
# Process-global table + environment knobs
# ---------------------------------------------------------------------------
_TABLE = None
_TABLE_LOCK = threading.Lock()


def tuning_enabled() -> bool:
    """``False`` when ``REPRO_TUNE`` is ``0``/``false``/``off``."""
    return os.environ.get("REPRO_TUNE", "1").strip().lower() not in (
        "0", "false", "off")


def default_cache_path() -> Path | None:
    """``$REPRO_TUNING_CACHE_DIR/tuning-table.json`` when the variable is
    set, else ``None``."""
    d = os.environ.get("REPRO_TUNING_CACHE_DIR")
    if not d:
        return None
    return Path(d) / TABLE_FILENAME


def get_table() -> TuningTable:
    """The process-global table (lazily loaded from the env cache dir)."""
    global _TABLE
    table = _TABLE
    if table is not None:
        return table
    with _TABLE_LOCK:
        if _TABLE is None:
            table = TuningTable()
            path = default_cache_path()
            if path is not None and path.exists():
                table.load(path)
            _TABLE = table
        return _TABLE


def set_table(table: TuningTable) -> None:
    global _TABLE
    with _TABLE_LOCK:
        _TABLE = table
    _invalidate()


def reset_table() -> None:
    """Drop the global table (re-resolved lazily; test/re-tune hook)."""
    global _TABLE
    with _TABLE_LOCK:
        _TABLE = None
    _invalidate()


def resolve_policy(family: str, *, backend=None, M=None, N=None, L=None,
                   dtype=None, measured: bool = True) -> dict:
    """Resolve one kernel invocation's policy via the global table."""
    return get_table().resolve(family, backend=backend, M=M, N=N, L=L,
                               dtype=dtype, measured=measured)


def tuning_fingerprint() -> str:
    """The global table's content hash (``"prior"`` until a tune)."""
    return get_table().fingerprint()


# ---------------------------------------------------------------------------
# Built-in family specs: the port's values on the H100 (runtime knobs with
# the candidates the sweep tries; build-time knobs as their .cu fixes them)
# ---------------------------------------------------------------------------
def _build(name: str, value) -> Knob:
    return Knob(name, value, build=True)


register_kernel_spec(KernelSpec(
    "plan",
    (Knob("method", {"cuda": "radix", "*": "fused"},
          candidates=("jnp", "fused", "pallas", "radix"),
          # on the card: B1/B2 (radix) or B12/B11 (pallas), never a
          # plain torch.sort path
          allowed={"cuda": ("pallas", "radix")}),),
    description="symbolic-phase sort backend (dispatch.sorted_permutation)",
))
register_kernel_spec(KernelSpec(
    "merge",
    (Knob("method", {"cuda": "pallas", "*": "jnp"},
          candidates=("jnp", "pallas"),
          allowed={"cuda": ("pallas",)}),  # B7 on the card
     # B7's shape (kernels/merge/ref.py merge_shape): dense where
     # Lq * dense_ratio >= n; the ladder reading rows on ties where
     # Lq * sparse_ratio < n and n >= sparse_targets; else the ladder
     Knob("dense_ratio", 4, candidates=(2, 4, 8, 32, 128)),
     Knob("sparse_ratio", 16, candidates=(4, 8, 16, 32, 64)),
     Knob("sparse_targets", 1 << 23,
          candidates=(1 << 21, 1 << 22, 1 << 23, 1 << 24)),
     _build("threads", 256),       # csrc/merge.cu kThreads
     _build("block_q", 1024),      # kThreads * kQueries
     _build("splitters", 256)),    # kSplitters
    description="delta merge-by-key search (SparsePattern.update, B7)",
    axes=("L",),  # L: the targets (kernels/merge/ref.py policy_key)
))
register_kernel_spec(KernelSpec(
    "radix_sort",
    (Knob("max_bits", 8, candidates=tuple(range(1, 9))),
     _build("kernel_max_bits", 8),  # csrc/radix_sort.cu kMaxBins = 256
     _build("threads", 256),        # kThreads
     _build("tile", 4096),          # kTile = kThreads * 16
     _build("hist_per_sm", 4),      # kHistPerSm: B1's resident wave
     _build("hist_chunk", 16)),     # kHistChunk: B1's tiles a flush
    description="LSD radix planner (B1, B2): the widest digit",
))
register_kernel_spec(KernelSpec(
    "counting_sort",
    (# B12's block: the power of two at or above nbins, within the range
     Knob("min_block_b", 1 << 16,
          candidates=(1 << 14, 1 << 15, 1 << 16, 1 << 17)),
     Knob("max_block_b", 1 << 20,
          candidates=(1 << 18, 1 << 19, 1 << 20, 1 << 21)),
     _build("hist_threads", 1024),  # csrc/hist.cu kThreads
     _build("threads", 512),        # csrc/counting_sort.cu kThreads
     _build("place_tile", 8192)),   # kTile = kThreads * 16
    description="counting-sort planner (method='pallas': B12, B11)",
    axes=("N", "L"),  # N: the bins, L: the keys (hist/ops.py policy_key)
))
register_kernel_spec(KernelSpec(
    "segment_sum",
    (_build("threads", 256),             # csrc/segment_sum.cu kThreads
     _build("seg_per", 8),               # kSegPer (B3', B4)
     _build("seg_min_blocks_f32", 5),    # kSegMinBlocks<float>
     _build("seg_min_blocks_f64", 4),
     _build("sum2_per", 8),              # kSum2Per (B6)
     _build("sum2_min_blocks_f32", 5),   # kSum2MinBlocks<float>
     _build("sum2_min_blocks_f64", 3),
     _build("scan_per", 16),             # ScanShape::kPer (B5)
     _build("scan_min_blocks_f32", 6),   # ScanShape<float>::kMinBlocks
     _build("scan_min_blocks_f64", 5)),
    description="fused gather + segment reductions (fills, SpGEMM)",
))
register_kernel_spec(KernelSpec(
    "spmv",
    (_build("block_r", 256),),           # csrc/spmv.cu kThreads
    description="padded-ELL SpMV (B8), one row a thread",
))
register_kernel_spec(KernelSpec(
    "spmv_sym",
    (# B9's shape (kernels/spmv_sym/ref.py sym_shape): one thread a
     # column where longest <= short_column and nzmax <= short_mean * M
     Knob("short_column", 32, candidates=(8, 16, 32, 64, 128)),
     Knob("short_mean", 4, candidates=(2, 4, 8, 16)),
     _build("threads", 256),             # csrc/spmv_sym.cu kThreads
     _build("sym_per", 8),               # kSymPer
     _build("sym_min_blocks_f32", 8),    # kSymMinBlocks<float>
     _build("sym_min_blocks_f64", 4)),
    description="symmetric / blocked SpMV streams (B9, B10)",
    axes=("M", "L"),  # M: the columns, L: the slots (spmv_sym/ref.py)
))
