"""The port's execution-policy layer (``repro_torch.sparse.tuning``).

Counterparts of ``tests/test_tuning.py``: resolution falls back to the
port's H100 priors, measured entries overlay them by specificity, tables
round-trip through schema-1 JSON (corrupt files degrade with
``CacheCorruptionWarning``), ``REPRO_TUNE`` / ``REPRO_TUNING_CACHE_DIR``
work, the module-level names are aliases of the registry, dispatch and
every kernel family resolve through the table, resolved policies are
bit-identical to explicit knobs, the validator and the constant lint
hold the single-home invariant, and the autotuner CLI runs on the CPU.
Held against the reference: one schema-1 file resolves to the same
policy with the same fingerprint in both packages.
"""
from __future__ import annotations

import json
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sparse import tuning as jax_tuning
from repro_torch.sparse import dispatch, tuning
from repro_torch.sparse.analysis import (lint_tuning_constants,
                                         validate_tuning_table)
from repro_torch.sparse.errors import (CacheCorruptionWarning,
                                       InvariantViolation)

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


@pytest.fixture(autouse=True)
def _fresh_table():
    """Each test gets an empty process-global table (and leaves none)."""
    tuning.set_table(tuning.TuningTable())
    yield
    tuning.reset_table()


def _triplets(seed, L=400, M=50, N=50):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, M + 1, L), rng.integers(1, N + 1, L),
            rng.integers(-4, 5, L).astype(np.float64), M, N)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
def test_registered_families_cover_all_kernel_layers():
    fams = tuning.registered_families()
    for fam in ("plan", "merge", "radix_sort", "segment_sum", "spmv",
                "spmv_sym", "counting_sort"):
        assert fam in fams


def test_unknown_family_and_knob_raise():
    with pytest.raises(KeyError, match="unknown kernel family"):
        tuning.kernel_spec("nope")
    with pytest.raises(KeyError, match="no knob"):
        tuning.kernel_spec("spmv").knob("warp_size")


def test_priors_are_the_ports_per_backend():
    assert tuning.prior_policy("plan", "cuda")["method"] == "radix"
    assert tuning.prior_policy("plan", "cpu")["method"] == "fused"
    assert tuning.prior_value("merge", "method", "cuda") == "pallas"
    assert tuning.prior_value("merge", "method", "cpu") == "jnp"
    # backend=None is the port's default device, CUDA
    assert tuning.resolve_policy("plan")["method"] == "radix"
    # no TPU prior becomes a port prior
    assert tuning.prior_value("counting_sort", "min_block_b") == 1 << 16
    assert not hasattr(tuning, "RESIDENT_BUDGET_BYTES")


@pytest.mark.parametrize("family,knob,source,pattern", [
    ("radix_sort", "threads", "radix_sort.cu", r"kThreads = (\d+);"),
    ("radix_sort", "tile", "radix_sort.cu", r"kPerThread = (\d+);"),
    ("radix_sort", "kernel_max_bits", "radix_sort.cu", r"kMaxBins = (\d+);"),
    ("segment_sum", "seg_per", "segment_sum.cu", r"kSegPer = (\d+);"),
    ("segment_sum", "sum2_per", "segment_sum.cu", r"kSum2Per = (\d+);"),
    ("segment_sum", "seg_min_blocks_f32", "segment_sum.cu",
     r"kSegMinBlocks = sizeof\(T\) == 4 \? (\d+)"),
    ("segment_sum", "sum2_min_blocks_f64", "segment_sum.cu",
     r"kSum2MinBlocks = sizeof\(T\) == 4 \? \d+ : (\d+);"),
    ("segment_sum", "scan_per", "segment_sum.cu", r"kPer = (\d+);"),
    ("counting_sort", "threads", "counting_sort.cu", r"kThreads = (\d+);"),
    ("counting_sort", "hist_threads", "hist.cu", r"kThreads = (\d+);"),
    ("spmv", "block_r", "spmv.cu", r"kThreads = (\d+);"),
    ("spmv_sym", "sym_per", "spmv_sym.cu", r"kSymPer = (\d+);"),
    ("spmv_sym", "sym_min_blocks_f32", "spmv_sym.cu",
     r"kSymMinBlocks = sizeof\(T\) == 4 \? (\d+)"),
    ("merge", "splitters", "merge.cu", r"kSplitters = (\d+);"),
])
def test_build_time_knobs_are_the_sources_values(family, knob, source,
                                                 pattern):
    """Each build-time prior is the value its ``.cu`` fixes (the
    replacement of the reference's single residency budget), and no table
    can override it."""
    got = int(re.search(pattern, (CSRC / source).read_text()).group(1))
    k = tuning.kernel_spec(family).knob(knob)
    want = k.default
    if knob == "tile":  # kTile = kThreads * kPerThread
        want = k.default // tuning.prior_value(family, "threads")
    elif knob == "kernel_max_bits":
        want = 1 << k.default
    assert k.build and k.candidates == () and got == want
    with pytest.raises(ValueError, match="fixed at build time"):
        tuning.get_table().record(family, {knob: 1}, backend="cuda")


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------
def test_resolve_without_entries_returns_priors():
    for fam in tuning.registered_families():
        assert tuning.resolve_policy(fam, backend="cpu") == \
            tuning.prior_policy(fam, "cpu")


def test_measured_entry_overrides_prior_by_bucket():
    t = tuning.get_table()
    t.record("radix_sort", {"max_bits": 6}, backend="cpu", L=100_000)
    pol = tuning.resolve_policy("radix_sort", backend="cpu", L=120_000)
    assert pol["max_bits"] == 6
    # same power-of-two bucket -> applies; different bucket -> priors
    far = tuning.resolve_policy("radix_sort", backend="cpu", L=100)
    assert far["max_bits"] == tuning.prior_value("radix_sort", "max_bits")
    # other knobs keep their priors; another backend is untouched
    assert pol["tile"] == tuning.prior_value("radix_sort", "tile")
    assert tuning.resolve_policy("radix_sort", backend="cuda",
                                 L=120_000)["max_bits"] == 8


def test_more_specific_entry_wins():
    t = tuning.get_table()
    t.record("spmv_sym", {"short_column": 16}, backend="cpu")
    t.record("spmv_sym", {"short_column": 64}, backend="cpu", L=1 << 20)
    assert tuning.resolve_policy("spmv_sym", backend="cpu",
                                 L=1 << 20)["short_column"] == 64
    assert tuning.resolve_policy("spmv_sym", backend="cpu",
                                 L=8)["short_column"] == 16


def test_measured_false_and_env_disable_return_priors(monkeypatch):
    t = tuning.get_table()
    t.record("spmv_sym", {"short_mean": 8}, backend="cpu")
    assert tuning.resolve_policy("spmv_sym", backend="cpu")["short_mean"] \
        == 8
    assert tuning.resolve_policy("spmv_sym", backend="cpu",
                                 measured=False)["short_mean"] == 4
    monkeypatch.setenv("REPRO_TUNE", "0")
    assert not tuning.tuning_enabled()
    assert tuning.resolve_policy("spmv_sym", backend="cpu")["short_mean"] \
        == 4


def test_record_rejects_unknown_family_and_knob():
    t = tuning.get_table()
    with pytest.raises(KeyError):
        t.record("nope", {"block_b": 1})
    with pytest.raises(KeyError):
        t.record("spmv_sym", {"block_q": 1})


def test_resolution_is_memoised_and_invalidated(tmp_path):
    """A repeated resolution is served from the memo (a fresh dict each
    time); ``record``, ``clear``, ``load``, ``set_table`` and
    ``reset_table`` all invalidate it."""
    res = dict(backend="cpu", L=1000)
    a = tuning.resolve_policy("merge", **res)
    a["method"] = "mutated"
    assert tuning.resolve_policy("merge", **res)["method"] == "jnp"
    t = tuning.get_table()
    t.record("merge", {"method": "pallas"}, backend="cpu")
    assert tuning.resolve_policy("merge", **res)["method"] == "pallas"
    t.clear()
    assert tuning.resolve_policy("merge", **res)["method"] == "jnp"
    other = tuning.TuningTable()
    other.record("merge", {"method": "pallas"}, backend="cpu")
    path = other.save(tmp_path / tuning.TABLE_FILENAME)
    assert t.load(path) == 1
    assert tuning.resolve_policy("merge", **res)["method"] == "pallas"
    tuning.set_table(tuning.TuningTable())
    assert tuning.resolve_policy("merge", **res)["method"] == "jnp"
    tuning.set_table(other)
    assert tuning.resolve_policy("merge", **res)["method"] == "pallas"
    tuning.reset_table()
    assert tuning.resolve_policy("merge", **res)["method"] == "jnp"


def test_memo_never_keeps_a_resolution_older_than_a_record():
    """Threads resolving while others record: once every record is in,
    every resolution sees the last one (a resolution computed across a
    record is not memoised)."""
    import sys
    import threading

    t = tuning.get_table()
    stop = threading.Event()

    def resolver():
        while not stop.is_set():
            tuning.resolve_policy("spmv_sym", backend="cpu", L=1000)

    def recorder(k):
        for v in range(1, 200):
            t.record("spmv_sym", {"short_column": 1000 * k + v},
                     backend="cpu", L=1000 + k)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=resolver) for _ in range(6)]
        writers = [threading.Thread(target=recorder, args=(0,))]
        for th in readers + writers:
            th.start()
        for th in writers:
            th.join(timeout=60)
        stop.set()
        for th in readers:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in readers + writers)
    assert tuning.resolve_policy("spmv_sym", backend="cpu",
                                 L=1000)["short_column"] == 199


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------
def test_table_round_trips_through_json(tmp_path):
    t = tuning.TuningTable()
    t.record("radix_sort", {"max_bits": 7}, backend="cpu", M=1000, N=1000,
             L=50_000, dtype=torch.float32)
    t.record("merge", {"method": "pallas"}, backend="cpu")
    path = t.save(tmp_path / tuning.TABLE_FILENAME)
    t2 = tuning.TuningTable()
    assert t2.load(path) == 2
    assert t2.entries() == t.entries()
    assert t2.fingerprint() == t.fingerprint()
    assert t2.resolve("radix_sort", backend="cpu", M=1000, N=1000, L=50_000,
                      dtype=np.float32)["max_bits"] == 7


def test_empty_table_fingerprints_as_prior():
    t = tuning.TuningTable()
    assert t.fingerprint() == "prior"
    t.record("spmv_sym", {"short_mean": 2}, backend="cpu")
    assert t.fingerprint() != "prior"


def test_corrupt_table_degrades_to_priors(tmp_path):
    path = tmp_path / tuning.TABLE_FILENAME
    path.write_text("{not json")
    t = tuning.TuningTable()
    with pytest.warns(CacheCorruptionWarning, match="corrupt tuning"):
        assert t.load(path) == 0
    assert t.resolve("spmv_sym", backend="cpu") == tuning.prior_policy(
        "spmv_sym", "cpu")
    path.write_text(json.dumps({"schema": 99, "entries": []}))
    with pytest.warns(CacheCorruptionWarning, match="schema"):
        assert tuning.TuningTable().load(path) == 0


def test_invalid_entries_are_skipped_individually(tmp_path):
    path = tmp_path / tuning.TABLE_FILENAME
    path.write_text(json.dumps({"schema": 1, "entries": [
        {"family": "spmv_sym", "policy": {"short_column": 64}},
        {"family": "not-a-family", "policy": {"x": 1}},
        {"family": "spmv", "policy": {"block_r": 512}},  # build-time
    ]}))
    t = tuning.TuningTable()
    with pytest.warns(CacheCorruptionWarning, match="invalid tuning"):
        assert t.load(path) == 1
    assert t.resolve("spmv_sym", backend="cpu")["short_column"] == 64


def test_env_cache_dir_loads_into_global_table(tmp_path, monkeypatch):
    t = tuning.TuningTable()
    t.record("spmv_sym", {"short_column": 64}, backend="cpu")
    t.save(tmp_path / tuning.TABLE_FILENAME)
    monkeypatch.setenv("REPRO_TUNING_CACHE_DIR", str(tmp_path))
    assert tuning.default_cache_path() == tmp_path / tuning.TABLE_FILENAME
    tuning.reset_table()
    assert tuning.resolve_policy("spmv_sym",
                                 backend="cpu")["short_column"] == 64
    assert len(tuning.get_table()) == 1


def test_no_env_means_no_default_cache_path(monkeypatch):
    monkeypatch.delenv("REPRO_TUNING_CACHE_DIR", raising=False)
    assert tuning.default_cache_path() is None


def test_one_file_resolves_alike_in_both_packages(tmp_path):
    """The same schema-1 JSON resolves to the same ``plan`` policy for
    backend ``"cpu"`` in the reference and the port, and both tables
    fingerprint it the same."""
    path = tmp_path / tuning.TABLE_FILENAME
    # bucketed entries before the backend-wide one: the reference's load
    # drops a backend-wide entry that a bucketed one of its family and
    # backend follows (ROADMAP queue C); the port restores every entry
    path.write_text(json.dumps({"schema": 1, "entries": [
        {"family": "plan", "policy": {"method": "pallas"}, "backend": "cpu",
         "L_bucket": 17, "source": "measured"},
        {"family": "plan", "policy": {"method": "radix"}, "backend": "cpu",
         "L_bucket": 17, "dtype": "float32", "source": "measured"},
        {"family": "plan", "policy": {"method": "jnp"}, "backend": "cpu",
         "source": "measured"},
        {"family": "plan", "policy": {"method": "fused"}, "backend": "tpu",
         "source": "measured"},
    ]}))
    ref, port = jax_tuning.TuningTable(), tuning.TuningTable()
    assert ref.load(path) == port.load(path) == 4
    assert ref.entries() == port.entries()
    assert ref.fingerprint() == port.fingerprint() != "prior"
    for L, dtype, method in ((10, None, "jnp"), (100_000, None, "pallas"),
                             (100_000, np.float32, "radix"),
                             (100_000, np.float64, "pallas")):
        got = port.resolve("plan", backend="cpu", L=L, dtype=dtype)
        assert got == ref.resolve("plan", backend="cpu", L=L, dtype=dtype)
        assert got["method"] == method
    assert port.resolve("plan", backend="cpu", L=100_000,
                        dtype=torch.float32)["method"] == "radix"


def test_load_restores_every_entry_in_any_order(tmp_path):
    """A backend-wide entry followed by a bucketed one of the same family
    and backend: both are kept, each serving its cells."""
    path = tmp_path / tuning.TABLE_FILENAME
    path.write_text(json.dumps({"schema": 1, "entries": [
        {"family": "plan", "policy": {"method": "jnp"}, "backend": "cpu"},
        {"family": "plan", "policy": {"method": "pallas"}, "backend": "cpu",
         "L_bucket": 17},
    ]}))
    t = tuning.TuningTable()
    assert t.load(path) == len(t) == 2
    assert t.resolve("plan", backend="cpu", L=10)["method"] == "jnp"
    assert t.resolve("plan", backend="cpu", L=100_000)["method"] == "pallas"


def test_no_env_table_is_the_prior():
    assert tuning.tuning_fingerprint() == "prior"


# ---------------------------------------------------------------------------
# Aliases: the module names are the registry's values
# ---------------------------------------------------------------------------
def test_module_aliases_are_the_registry_priors():
    from repro_torch.kernels.counting_sort.ref import PLACE_TILE
    from repro_torch.kernels.hist import ops as hist_ops
    from repro_torch.kernels.merge import ref as merge_ref
    from repro_torch.kernels.radix_sort import ops as radix_ops
    from repro_torch.kernels.radix_sort.radix_sort import TILE
    from repro_torch.kernels.segment_sum import ref as seg_ref
    from repro_torch.kernels.spmv.spmv import BLOCK_R
    from repro_torch.kernels.spmv_sym import ref as sym_ref

    p = tuning.prior_value
    assert (radix_ops.MAX_BITS, TILE) == (p("radix_sort", "max_bits"),
                                          p("radix_sort", "tile"))
    assert (hist_ops.MIN_BLOCK_B, hist_ops.MAX_BLOCK_B, PLACE_TILE) == (
        1 << 16, 1 << 20, 8192)
    assert (merge_ref.DENSE_RATIO, merge_ref.SPARSE_RATIO,
            merge_ref.SPARSE_TARGETS, merge_ref.BLOCK_Q,
            merge_ref.SPLITTERS) == (4, 16, 1 << 23, 1024, 256)
    assert (sym_ref.SHORT_COLUMN, sym_ref.SHORT_MEAN, sym_ref.SYM_TILE) == (
        32, 4, 2048)
    assert (seg_ref.SEG_TILE, seg_ref.PRODUCT_TILE, seg_ref.SCAN_TILE,
            BLOCK_R) == (2048, 2048, 4096, 256)
    assert dispatch.DEFAULT_METHOD_CUDA == "radix"
    assert dispatch.DEFAULT_MERGE_CPU == "jnp"


# ---------------------------------------------------------------------------
# Consumers: dispatch + bit-identical resolution
# ---------------------------------------------------------------------------
def test_dispatch_defaults_resolve_through_table():
    assert dispatch.default_method("cpu") == "fused"
    tuning.get_table().record("plan", {"method": "jnp"}, backend="cpu")
    assert dispatch.default_method("cpu") == "jnp"
    assert dispatch.resolve_method(None, "cpu") == "jnp"
    assert dispatch.resolve_method("radix", "cpu") == "radix"
    assert dispatch.method_from_fused(None, None, "cpu") == "jnp"
    assert dispatch.default_method("cuda") == "radix"
    tuning.get_table().record("merge", {"method": "pallas"}, backend="cpu")
    assert dispatch.default_merge_method("cpu") == "pallas"
    assert dispatch.resolve_merge_method(None, "cpu") == "pallas"
    # a shape-specific entry reaches sorted_permutation's resolution
    tuning.get_table().record("plan", {"method": "pallas"}, backend="cpu",
                              M=50, N=50, L=400)
    assert dispatch.default_method("cpu", M=50, N=50, L=400) == "pallas"


@pytest.mark.parametrize("family,plain", [("plan", "fused"),
                                          ("plan", "jnp"),
                                          ("merge", "jnp")])
def test_no_table_entry_moves_a_cuda_call_off_the_kernels(family, plain,
                                                          tmp_path):
    """A plain method recorded for CUDA (or for every backend) is
    refused, and a file holding one loads without it: the CUDA
    resolution stays on the hand-written kernels."""
    t = tuning.get_table()
    for backend in ("cuda", None):
        with pytest.raises(ValueError, match="not allowed"):
            t.record(family, {"method": plain}, backend=backend)
    t.record(family, {"method": plain}, backend="cpu")  # the CPU may
    path = tmp_path / tuning.TABLE_FILENAME
    path.write_text(json.dumps({"schema": 1, "entries": [
        {"family": family, "policy": {"method": plain}, "backend": "cuda"},
        {"family": family, "policy": {"method": plain}, "L_bucket": 22},
    ]}))
    with pytest.warns(CacheCorruptionWarning, match="not allowed"):
        assert t.load(path) == 0
    default = (dispatch.default_method if family == "plan"
               else dispatch.default_merge_method)
    assert default("cuda", L=2_500_000) == tuning.prior_value(
        family, "method", "cuda")
    assert default("cpu", L=2_500_000) == plain
    assert plain not in {p["method"] for p in _candidates(family, "cuda")}


def _candidates(family, backend):
    from repro_torch.sparse.tuning.measure import candidate_policies

    return candidate_policies(family, backend)


@pytest.mark.parametrize("family,dims", [
    ("counting_sort", {"M": 5, "N": None, "L": 100}),
    ("merge", {"M": 5, "N": None, "L": 100}),
    ("spmv_sym", {"M": None, "N": 5, "L": 100}),
])
def test_records_and_lookups_off_a_familys_axes_raise(family, dims):
    """Each family is keyed only on the sizes its call site resolves at,
    so no entry can be recorded where no lookup finds it."""
    knob = next(k for k in tuning.kernel_spec(family).knobs if k.candidates)
    with pytest.raises(ValueError, match="resolves at"):
        tuning.get_table().record(family, {knob.name: knob.candidates[0]},
                                  backend="cpu", **dims)
    with pytest.raises(ValueError, match="resolves at"):
        tuning.resolve_policy(family, backend="cpu", **dims)


def test_kernel_shape_pickers_resolve_through_table():
    from repro_torch.kernels.hist.ops import default_block_b
    from repro_torch.kernels.merge.ref import merge_shape
    from repro_torch.kernels.spmv_sym.ref import sym_shape

    assert merge_shape(10, 1000, backend="cpu") == "ladder"
    assert sym_shape(8, 100, 300, backend="cpu") == "columns"
    assert default_block_b(10_001, backend="cpu") == 1 << 16
    t = tuning.get_table()
    t.record("merge", {"dense_ratio": 128}, backend="cpu")
    t.record("spmv_sym", {"short_column": 4}, backend="cpu")
    t.record("counting_sort", {"min_block_b": 1 << 14}, backend="cpu")
    assert merge_shape(10, 1000, backend="cpu") == "dense"
    assert sym_shape(8, 100, 300, backend="cpu") == "tiles"
    assert default_block_b(10_001, backend="cpu") == 1 << 14
    # CUDA keeps its priors
    assert merge_shape(10, 1000, backend="cuda") == "ladder"


def test_resolved_policy_bit_identical_to_explicit_knobs():
    """Under the priors, ``fsparse``, ``update``, B7's offsets, the
    counting and radix sorts and the symmetric SpMV give the bits that
    passing every knob explicitly gives."""
    from repro_torch.kernels.counting_sort.ops import counting_sort
    from repro_torch.kernels.merge.ops import merge_search
    from repro_torch.kernels.radix_sort.ops import radix_sort_pair
    from repro_torch.kernels.spmv_sym.ops import spmv_sym
    from repro_torch.sparse import convert, fsparse, plan

    ii, jj, ss, M, N = _triplets(0)
    prior = {f: tuning.prior_policy(f, "cpu")
             for f in tuning.registered_families()}
    A = fsparse(ii, jj, ss, (M, N), device="cpu")
    B = fsparse(ii, jj, ss, (M, N), device="cpu",
                method=prior["plan"]["method"])
    for f in ("data", "indices", "indptr", "nnz"):
        assert torch.equal(getattr(A, f), getattr(B, f))
    rows = torch.from_numpy(ii - 1).to(torch.int32)
    cols = torch.from_numpy(jj - 1).to(torch.int32)
    base = plan(rows[:300], cols[:300], (M, N), nzmax=400)
    u1 = base.update(rows[300:], cols[300:])
    u2 = base.update(rows[300:], cols[300:], method=prior["plan"]["method"],
                     merge_method=prior["merge"]["method"])
    for f in ("perm", "slot", "indices", "indptr", "nnz"):
        assert torch.equal(getattr(u1, f), getattr(u2, f))
    knobs = {k: prior["merge"][k] for k in ("dense_ratio", "sparse_ratio",
                                            "sparse_targets")}
    q = (rows[300:], cols[300:])
    assert torch.equal(merge_search(*q, base.srows, base.scols),
                       merge_search(*q, base.srows, base.scols, **knobs))
    assert torch.equal(radix_sort_pair(rows, cols, M=M, N=N),
                       radix_sort_pair(rows, cols, M=M, N=N,
                                       max_bits=prior["radix_sort"][
                                           "max_bits"]))
    from repro_torch.kernels.hist.ops import default_block_b

    bb = default_block_b(M + 1, min_block_b=prior["counting_sort"][
        "min_block_b"], max_block_b=prior["counting_sort"]["max_block_b"])
    for a, b in zip(counting_sort(rows, nbins=M + 1),
                    counting_sort(rows, nbins=M + 1, block_b=bb)):
        assert torch.equal(a, b)
    S = fsparse(np.concatenate([ii, jj]), np.concatenate([jj, ii]),
                np.concatenate([ss, ss]), (M, M), device="cpu")
    Y = convert(S, "symcsc")
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -3, 4, M).astype(np.float64))
    sk = {k: prior["spmv_sym"][k] for k in ("short_column", "short_mean")}
    assert torch.equal(
        spmv_sym(Y.diag, Y.data, Y.indices, Y.indptr, x, longest=Y.longest),
        spmv_sym(Y.diag, Y.data, Y.indices, Y.indptr, x, longest=Y.longest,
                 **sk))


# ---------------------------------------------------------------------------
# Analysis layer: validator + constant lint
# ---------------------------------------------------------------------------
def test_validate_tuning_table_accepts_recorded_entries():
    t = tuning.get_table()
    t.record("radix_sort", {"max_bits": 6}, backend="cpu", L=1000)
    t.record("plan", {"method": "pallas"}, backend="cuda", L=1000)
    t.record("merge", {"method": "jnp"}, backend="cpu", L=1000)
    assert validate_tuning_table(t) == 3


class _StubTable:
    def __init__(self, entries):
        self._entries = entries

    def entries(self):
        return self._entries


@pytest.mark.parametrize("entry,invariant", [
    ({"family": "nope", "policy": {}}, "tuning-unknown-family"),
    ({"family": "spmv_sym", "policy": {"block_q": 1}},
     "tuning-unknown-knob"),
    ({"family": "spmv_sym", "policy": {"short_column": "big"}},
     "tuning-bad-value"),
    ({"family": "spmv_sym", "policy": {"short_column": -4}},
     "tuning-bad-value"),
    ({"family": "spmv", "policy": {"block_r": 512}}, "tuning-bad-value"),
    # a plain method where the table steers CUDA tensors
    ({"family": "plan", "policy": {"method": "fused"}, "backend": "cuda"},
     "tuning-bad-value"),
    ({"family": "merge", "policy": {"method": "jnp"}}, "tuning-bad-value"),
    # keyed where its call site never looks
    ({"family": "counting_sort", "policy": {"min_block_b": 1 << 15},
      "M_bucket": 18}, "tuning-bad-axis"),
])
def test_validate_tuning_table_rejects_drifted_entries(entry, invariant):
    with pytest.raises(InvariantViolation) as exc:
        validate_tuning_table(_StubTable([entry]))
    assert invariant in str(exc.value)


def test_tuning_lint_port_is_clean():
    assert lint_tuning_constants() == []


def test_tuning_lint_flags_rescattered_constants(tmp_path):
    bad = tmp_path / "bad_ops.py"
    bad.write_text(
        "BLOCK_B = 4096\n"
        "MERGE_RESIDENT_MAX_BYTES = 8 << 20\n"
        "PASS_BYTES = 22.0\n"
        "DENSE_RATIO = 4\n"
        "SPARSE_TARGETS = 1 << 23\n"
        "SHORT_COLUMN = 32\n"
        "SEG_TILE = 2048\n"
        "CLEAN = tuning.prior_value('radix_sort', 'tile')\n"
        "SYM_TILE = 256 * SYM_PER\n"
        "def kernel(x, block_b=2048, *, short_mean=4, max_bits=None):\n"
        "    return x\n"
    )
    findings = lint_tuning_constants([bad])
    names = sorted(f["name"] for f in findings)
    assert names == ["BLOCK_B", "DENSE_RATIO", "MERGE_RESIDENT_MAX_BYTES",
                     "PASS_BYTES", "SEG_TILE", "SHORT_COLUMN",
                     "SPARSE_TARGETS", "block_b", "short_mean"]


def test_tuning_lint_catches_a_literal_planted_in_the_port(tmp_path):
    """The lint is not clean only because the port named its constants
    differently: a literal put back in a linted file is found."""
    from repro_torch.sparse.analysis.tuning_check import (
        DEFAULT_TUNING_LINT_PATHS)

    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for rel in DEFAULT_TUNING_LINT_PATHS:
        src = (root / rel).read_text()
        planted = tmp_path / rel.replace("/", "_")
        planted.write_text(src + "\nSHORT_MEAN = 4\n")
        assert [f["name"] for f in lint_tuning_constants([planted])] == [
            "SHORT_MEAN"], rel


# ---------------------------------------------------------------------------
# The CLI (prior-only and, on the CPU, measure)
# ---------------------------------------------------------------------------
def test_cli_prior_only_writes_artifact_and_consumes_report(tmp_path,
                                                            capsys):
    from repro_torch.sparse.analysis.vmem import dump_json, vmem_report
    from repro_torch.sparse.tuning.__main__ import main

    report = tmp_path / "vmem-report.json"
    rows = vmem_report(device="cpu")
    dump_json(rows, str(report))
    out = tmp_path / "tuning-table.json"
    rc = main(["--prior-only", "--vmem-report", str(report), "--json",
               str(out), "--cache-dir", str(tmp_path / "cache"),
               "--device", "cpu"])
    assert rc == 0
    assert "rows consumed" in capsys.readouterr().out
    artifact = json.loads(out.read_text())
    assert artifact["fingerprint"] == "prior"
    assert artifact["backend"] == "cpu"
    assert artifact["consumed_vmem_rows"] == len(rows) >= 12
    assert set(artifact["priors"]) == set(tuning.registered_families())
    for fam in tuning.registered_families():
        assert artifact["resolved"][fam] == artifact["priors"][fam]
    t = tuning.TuningTable()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert t.load(tmp_path / "cache" / tuning.TABLE_FILENAME) == 0
    assert t.fingerprint() == "prior"


def test_cli_prior_only_fails_on_diverged_report(tmp_path, capsys):
    from repro_torch.sparse.analysis.vmem import dump_json, vmem_report
    from repro_torch.sparse.tuning.__main__ import main

    report = tmp_path / "vmem-report.json"
    dump_json(vmem_report(device="cpu"), str(report))
    payload = json.loads(report.read_text())
    payload["vmem_report"][0]["knobs"]["tile"] = 123
    report.write_text(json.dumps(payload))
    assert main(["--prior-only", "--vmem-report", str(report),
                 "--device", "cpu"]) == 1
    assert "FAIL" in capsys.readouterr().err


def test_cli_measure_holds_every_candidate_and_records(tmp_path, capsys):
    """``--measure`` on the CPU at a small scale: every candidate of
    every measurable family runs, agrees with the prior, is timed, and
    the table saved loads back."""
    from repro_torch.sparse.tuning.__main__ import main
    from repro_torch.sparse.tuning.measure import (MEASURABLE_FAMILIES,
                                                   candidate_policies)

    from repro_torch.sparse.tuning.measure import decision, make_dataset

    rc = main(["--measure", "--device", "cpu", "--scale", "0.01",
               "--min-gain", "0.5", "--cache-dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    dims = make_dataset(scale=0.01, device="cpu")["dims"]

    def distinct(f):  # one timed candidate per call-site decision
        seen = []
        for pol in candidate_policies(f, "cpu"):
            how = decision(f, dims, pol, "cpu")
            seen += [how] if how not in seen else []
        return len(seen)

    assert out.count(" ms on cpu (") == sum(distinct(f)
                                            for f in MEASURABLE_FAMILIES)
    assert out.count("within 16 eps") == distinct("spmv_sym")
    t = tuning.TuningTable()
    t.load(tmp_path / tuning.TABLE_FILENAME)
    assert validate_tuning_table(t) == len(t)
    assert t.fingerprint() == tuning.tuning_fingerprint()


def test_measure_rejects_a_candidate_that_disagrees():
    from repro_torch.sparse.tuning.measure import (make_dataset, run_policy,
                                                   same_result)

    data = make_dataset(scale=0.005, device="cpu")
    prior = tuning.prior_policy("plan", "cpu")
    want = run_policy("plan", prior, data)
    assert same_result("plan", want, want, data) == "bit for bit"
    with pytest.raises(RuntimeError, match="differs"):
        same_result("plan", (want[0].flip(0),), want, data)
    y = run_policy("spmv_sym", tuning.prior_policy("spmv_sym", "cpu"), data)
    with pytest.raises(RuntimeError, match="16 eps"):
        same_result("spmv_sym", (y[0] + 1.0,), y, data)
    with pytest.raises(ValueError, match="no measurer"):
        run_policy("nope", {}, data)


def test_candidate_grid_is_prior_anchored():
    from repro_torch.sparse.tuning.measure import candidate_policies

    cands = candidate_policies("merge", "cuda")
    assert cands[0] == tuning.prior_policy("merge", "cuda")
    swept = {k.name for k in tuning.kernel_spec("merge").knobs
             if not k.build}
    for pol in cands[1:]:
        diff = {k for k in pol if pol[k] != cands[0][k]}
        assert len(diff) == 1 and diff <= swept
    assert len(cands) == 1 + sum(
        len([c for c in k.candidates if c != k.prior("cuda")
             and k.allows(c, "cuda")])
        for k in tuning.kernel_spec("merge").knobs)
    assert {p["method"] for p in cands} == {"pallas"}
    assert {p["method"] for p in candidate_policies("plan", "cuda")} == {
        "radix", "pallas"}


@pytest.mark.parametrize("family", ["plan", "radix_sort", "counting_sort",
                                    "merge", "spmv_sym"])
def test_a_recorded_winner_reaches_its_call_site(family):
    """An entry recorded as the sweep records it (at the family's
    ``policy_key`` of the dataset) changes what the call site itself
    resolves to: every candidate's decision is reached."""
    from repro_torch.kernels.hist.ops import default_block_b
    from repro_torch.kernels.merge.ref import merge_shape
    from repro_torch.kernels.spmv_sym.ref import sym_shape
    from repro_torch.sparse.tuning.measure import (candidate_policies,
                                                   decision, policy_key)

    # set 1's sizes at 2.5e6; a FEM-like SymCSC: 3 slots a column
    M, L = 50_000, 2_500_000
    dims = {"M": M, "N": M, "L": L, "nbins": M + 1, "Lq": L // 100,
            "n": L - L // 100, "sym_M": 1000, "nzmax": 3000, "longest": 4}
    prior = decision(family, dims, None, "cpu")
    reached = {json.dumps(prior)}
    for pol in candidate_policies(family, "cpu")[1:]:
        want = decision(family, dims, pol, "cpu")
        if want == prior:
            continue
        t = tuning.TuningTable()
        tuning.set_table(t)
        t.record(family, {k: v for k, v in pol.items()
                          if v != tuning.prior_value(family, k, "cpu")},
                 backend="cpu", **policy_key(family, dims))
        assert decision(family, dims, None, "cpu") == want
        # an entry for the CPU leaves the card's resolution alone
        assert decision(family, dims, None, "cuda") == decision(
            family, dims, tuning.prior_policy(family, "cuda"), "cuda")
        reached.add(json.dumps(want))
    assert len(reached) > 1
    # the call sites themselves, with the dataset's own arguments
    t = tuning.TuningTable()
    tuning.set_table(t)
    t.record("counting_sort", {"min_block_b": 1 << 15}, backend="cuda",
             **policy_key("counting_sort", {"nbins": 1001, "L": L}))
    assert default_block_b(1001, L=L, backend="cuda") == 1 << 15
    t.record("merge", {"dense_ratio": 128}, backend="cuda",
             **policy_key("merge", dims))
    assert merge_shape(dims["Lq"], dims["n"], backend="cuda") == "dense"
    t.record("spmv_sym", {"short_mean": 2}, backend="cuda",
             **policy_key("spmv_sym", dims))
    assert sym_shape(4, 1000, 3000, backend="cuda") == "tiles"


@pytest.mark.parametrize("module,absent", [
    ("sparse.tuning", {"RESIDENT_BUDGET_BYTES"}),
    ("sparse.tuning.measure", set()),
    ("sparse.analysis", {"RetraceAuditor", "audit_retraces"}),
    ("sparse.analysis.vmem", set()),
    ("sparse.analysis.contracts", {"RetraceAuditor", "audit_retraces"}),
    ("sparse.analysis.concurrency", set()),
    ("sparse.analysis.tuning_check", set()),
])
def test_public_names_match_the_reference(module, absent):
    """Every public name of the reference's policy and analysis modules
    is in the port's, but the deliberate absences (the VMEM budget; the
    retrace audit, waiting for the serving module's executable tier)."""
    import importlib

    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    assert sorted(n for n in ref.__all__ if not hasattr(port, n)) == \
        sorted(absent)


@pytest.mark.parametrize("cli", ["tuning", "analysis"])
def test_clis_default_to_the_card(cli):
    """Without ``--device`` both CLIs run on CUDA: with no card they
    raise instead of falling back to the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    main = importlib.import_module(f"repro_torch.sparse.{cli}.__main__").main
    argv = ["--prior-only"] if cli == "tuning" else ["--invariants"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
