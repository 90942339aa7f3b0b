"""The plan service (``sparse/serving.py``) against the JAX package's.

The same seeded numpy triplets go to ``repro.sparse.serving.PlanService``
(JAX, CPU) and to the port's ``PlanService(device="cpu")``.  Integer
structure (``indices``, ``indptr``, ``nnz``) must be bit-identical;
values bit-identical on integer-valued data and within the dtype's
tolerance otherwise (the port's fill sums each slot directly where the
reference differences a prefix sum: ROADMAP queue C).  Every port
result is also held bit for bit against the port's uncached path
(``fsparse``, ``sparse2``, ``ops.matmul``): the service's own contract.
On the CPU the executable tier runs eagerly, with no graph, and counts
captures and replays as a CUDA service does; ``tests/test_torch_gpu.py``
holds the captured graphs on the card.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jax_serve
from repro.sparse import LRUCache as JaxLRU
from repro.sparse import PlanService as JaxService
from repro.sparse import fsparse as jax_fsparse
from repro.sparse import plan as jax_plan
from repro.sparse import plan_cache_clear as jax_plan_clear
from repro.sparse import product_cache_clear as jax_product_clear
from repro.sparse.analysis.contracts import RetraceAuditor as JaxAuditor
from repro.sparse.formats import convert as jax_convert
from repro_torch.sparse import (CacheCorruptionWarning, LRUCache, PlanService,
                                find, fsparse, ops, plan, plan_cache_clear,
                                plan_cache_info, product_cache_clear,
                                product_cache_info, sparse2)
from repro_torch.sparse.analysis import RetraceAuditor, audit_retraces
from repro_torch.sparse.errors import InvariantViolation
from repro_torch.sparse.formats import convert
from repro_torch.sparse.matlab import plan_lookup
from repro_torch.sparse.ops import spmv_impl
from repro_torch.sparse import serving
from repro_torch.sparse.serving import (Executable, _IdentityMemo,
                                        _memo_structure_key,
                                        apply_runtime_env,
                                        enable_compilation_cache,
                                        load_caches, runtime_env,
                                        save_caches, tcmalloc_hint)
from repro_torch.sparse.spgemm import _structure_key

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Both packages' global caches start and end empty."""
    for clear in (plan_cache_clear, product_cache_clear, jax_plan_clear,
                  jax_product_clear):
        clear()
    yield
    for clear in (plan_cache_clear, product_cache_clear, jax_plan_clear,
                  jax_product_clear):
        clear()


def _triplet(n: int, L: int, seed: int = 0, integer: bool = False):
    rng = np.random.default_rng(seed)
    ii = rng.integers(1, n + 1, L)
    jj = rng.integers(1, n + 1, L)
    if integer:
        ss = rng.integers(-8, 9, L).astype(np.float32)
    else:
        ss = rng.normal(size=L).astype(np.float32)
    return ii, jj, ss


def _delta(n: int, Ld: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, n + 1, Ld), rng.integers(1, n + 1, Ld),
            rng.integers(-8, 9, Ld).astype(np.float32))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(A, B):
    """Bit for bit: structure and values."""
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(_np(getattr(A, f)),
                                      _np(getattr(B, f)), err_msg=f)
    assert int(A.nnz) == int(B.nnz) and tuple(A.shape) == tuple(B.shape)


def _close(A, B):
    """Structure bit for bit; values within float32 tolerance."""
    for f in ("indptr", "indices"):
        np.testing.assert_array_equal(_np(getattr(A, f)),
                                      _np(getattr(B, f)), err_msg=f)
    assert int(A.nnz) == int(B.nnz) and tuple(A.shape) == tuple(B.shape)
    np.testing.assert_allclose(_np(A.data), _np(B.data), rtol=1e-5,
                               atol=1e-5)


def _services(**kw):
    return PlanService(device=CPU, **kw), JaxService(**kw)


# ---------------------------------------------------------------------------
# LRUCache.items
# ---------------------------------------------------------------------------
def test_lru_items_snapshot_matches_reference():
    caches = (LRUCache(3), JaxLRU(3))
    for c in caches:
        for k in "abcd":               # evicts "a"
            c.insert(k, k.upper())
        c.get("b")                     # b becomes most recent
    snaps = [c.items() for c in caches]
    assert snaps[0] == snaps[1] == [("c", "C"), ("d", "D"), ("b", "B")]
    caches[0].insert("e", "E")         # a snapshot, not a live view
    assert snaps[0] == [("c", "C"), ("d", "D"), ("b", "B")]


# ---------------------------------------------------------------------------
# PlanService: the executable tier against uncached dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("integer", [True, False])
def test_service_assemble_matches_fsparse_and_reference(integer):
    n, L = 60, 500
    ii, jj, ss = _triplet(n, L, integer=integer)
    svc, ref = _services()
    check = _same if integer else _close
    for scale in (1, 2):
        A = svc.assemble(ii, jj, ss * scale, (n, n))
        _same(A, fsparse(ii, jj, ss * scale, (n, n), device=CPU))
        check(A, ref.assemble(ii, jj, ss * scale, (n, n)))
    st, st_ref = svc.stats(), ref.stats()
    assert st["plan"]["hits"] >= 1
    assert st["exec"] == st_ref["exec"] == {
        "size": 1, "capacity": 64, "hits": 1, "misses": 1, "evictions": 0,
        "insertions": 1}
    assert st["graphs"] == {"captures": {"fill": 1},
                            "replays": {"fill": 2}}
    assert st["graph_mode"] == "eager" and st["device"] == "cpu"


@pytest.mark.parametrize("accum",
                         ["sum", "min", "max", "mean", "first", "last"])
def test_service_assemble_accum_modes(accum):
    ii = np.array([1, 1, 2, 3, 1])
    jj = np.array([1, 1, 2, 3, 1])
    ss = np.array([5.0, -2.0, 3.0, 4.0, 1.0], np.float32)
    svc, ref = _services()
    A = svc.assemble(ii, jj, ss, (3, 3), accum=accum)
    _same(A, sparse2(ii, jj, ss, (3, 3), accum=accum, device=CPU))
    _same(A, ref.assemble(ii, jj, ss, (3, 3), accum=accum))


def test_service_multiply_matches_ops_matmul_and_reference():
    n = 50
    ii, jj, ss = _triplet(n, 300, seed=1, integer=True)
    kk, ll, tt = _triplet(n, 300, seed=2, integer=True)
    A = fsparse(ii, jj, ss, (n, n), device=CPU)
    B = fsparse(kk, ll, tt, (n, n), device=CPU)
    svc, ref = _services()
    C = svc.multiply(A, B)
    _same(C, ops.matmul(A, B))
    _same(C, ref.multiply(jax_fsparse(ii, jj, ss, (n, n)),
                          jax_fsparse(kk, ll, tt, (n, n))))
    _same(svc.multiply(A, B), C)      # replay
    assert svc.stats()["exec"]["hits"] == 1
    assert svc.stats()["graphs"]["replays"] == {"multiply": 2}


def _formats(n=32, seed=21):
    """One symmetric integer-valued matrix in both packages and every
    format the tier captures (SymCSC needs the symmetry, BSR a block
    that divides n)."""
    rng = np.random.default_rng(seed)
    r0 = rng.integers(1, n + 1, 100)
    c0 = rng.integers(1, n + 1, 100)
    v0 = rng.integers(-4, 5, 100).astype(np.float32)
    ii, jj = np.concatenate([r0, c0]), np.concatenate([c0, r0])
    ss = np.concatenate([v0, v0])
    S = fsparse(ii, jj, ss, (n, n), device=CPU)
    Sj = jax_fsparse(ii, jj, ss, (n, n))
    return {
        "csc": (S, Sj),
        "csr": (convert(S, "csr"), jax_convert(Sj, "csr")),
        "symcsc": (convert(S, "symcsc"), jax_convert(Sj, "symcsc")),
        "bsr": (convert(S, "bsr", block=2),
                jax_convert(Sj, "bsr", block=2)),
    }


@pytest.mark.parametrize("fmt", ["csc", "csr", "symcsc", "bsr"])
def test_service_spmv_every_format_matches_dispatch_and_reference(fmt):
    n = 32
    S, Sj = _formats(n)[fmt]
    rng = np.random.default_rng(7)
    x = rng.integers(-3, 4, n).astype(np.float32)
    X = rng.integers(-3, 4, (n, 3)).astype(np.float32)
    svc, ref = _services()
    y = svc.spmv(S, torch.from_numpy(x))
    np.testing.assert_array_equal(
        _np(y), _np(ops.matmul(S, torch.from_numpy(x))))
    np.testing.assert_array_equal(_np(y), _np(ref.spmv(Sj, jnp.asarray(x))))
    Y = svc.spmv(S, torch.from_numpy(X))
    fn, Sr = spmv_impl(S)
    Xt = torch.from_numpy(X)
    np.testing.assert_array_equal(
        _np(Y), _np(torch.stack([fn(Sr, Xt[:, j]) for j in range(3)], 1)))
    np.testing.assert_array_equal(_np(Y), _np(ref.spmv(Sj, jnp.asarray(X))))
    h0 = svc.stats()["exec"]["hits"]
    np.testing.assert_array_equal(_np(svc.spmv(S, torch.from_numpy(x))),
                                  _np(y))
    assert svc.stats()["exec"]["hits"] == h0 + 1
    ref.spmv(Sj, jnp.asarray(x))
    assert svc.stats()["exec"] == ref.stats()["exec"]


def test_service_spmv_random_values_within_tolerance():
    n = 64
    ii, jj, ss = _triplet(n, 400, seed=3)
    S = fsparse(ii, jj, ss, (n, n), device=CPU)
    x = np.random.default_rng(7).normal(size=n).astype(np.float32)
    svc, ref = _services()
    y = _np(svc.spmv(S, torch.from_numpy(x)))
    np.testing.assert_array_equal(
        y, _np(ops.matmul(S, torch.from_numpy(x))))
    want = _np(ref.spmv(jax_fsparse(ii, jj, ss, (n, n)), jnp.asarray(x)))
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="vector or matrix"):
        svc.spmv(S, torch.ones((2, 2, 2)))


def test_service_assemble_many_groups_and_preserves_order():
    n = 40
    ii_a, jj_a, ss_a = _triplet(n, 300, seed=4, integer=True)
    ii_b, jj_b, ss_b = _triplet(n, 200, seed=5, integer=True)
    reqs = [
        (ii_a, jj_a, ss_a, (n, n)),
        (ii_b, jj_b, ss_b, (n, n)),
        (ii_a, jj_a, ss_a * 2, (n, n)),
        (ii_a, jj_a, ss_a - 1, (n, n)),
    ]
    svc, ref = _services()
    out = svc.assemble_many(reqs)
    out_ref = ref.assemble_many(reqs)
    # one batched executable (B = 3) and one singleton, in both packages
    assert svc.stats()["exec"] == ref.stats()["exec"]
    assert svc.stats()["exec"]["insertions"] == 2
    assert svc.stats()["graphs"]["captures"] == {"fill": 2}
    assert len(out) == 4
    for got, want, (i, j, s, shp) in zip(out, out_ref, reqs):
        _same(got, fsparse(i, j, s, shp, device=CPU))
        _same(got, svc.assemble(i, j, s, shp))
        _same(got, want)


def test_service_concurrent_requests_bit_identical():
    n, L = 50, 400
    ii, jj, ss = _triplet(n, L, seed=6)
    want = fsparse(ii, jj, ss, (n, n), device=CPU)
    svc = PlanService(device=CPU)
    errors = []
    barrier = threading.Barrier(4)

    def worker(k):
        try:
            barrier.wait(timeout=30)
            for r in range(6):
                scale = np.float32(1 + (k + r) % 3)
                got = svc.assemble(ii, jj, ss * scale, (n, n))
                _same(got, fsparse(ii, jj, ss * scale, (n, n), device=CPU))
            _same(svc.assemble(ii, jj, ss, (n, n)), want)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    st = svc.stats()
    assert st["exec"]["size"] == 1
    assert st["graphs"]["replays"] == {"fill": 28}


def test_service_donate_and_device_defaults():
    assert PlanService(device=CPU).donate is False
    assert PlanService(device=CPU, donate=True).donate is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PlanService()


# ---------------------------------------------------------------------------
# update_structure
# ---------------------------------------------------------------------------
def test_service_update_structure_matches_cold_assemble():
    n, L, Ld = 40, 300, 30
    ii, jj, ss = _triplet(n, L, seed=30, integer=True)
    ai, aj, av = _delta(n, Ld, seed=31)
    dm = np.zeros(L, bool)
    dm[np.random.default_rng(32).choice(L, 20, replace=False)] = True
    svc, ref = _services()
    outs = []
    for s in (svc, ref):
        s.assemble(ii, jj, ss, (n, n), L + Ld)   # warm, with headroom
        outs.append(s.update_structure(ii, jj, ss, ai, aj, av, (n, n),
                                       L + Ld, drop_mask=dm))
    keep = ~dm
    cold = fsparse(np.concatenate([ii[keep], ai]),
                   np.concatenate([jj[keep], aj]),
                   np.concatenate([ss[keep], av]), (n, n), nzmax=L + Ld,
                   device=CPU)
    _same(outs[0], cold)
    _same(outs[0], outs[1])


def test_service_update_retires_only_affected_executables():
    n, cap = 40, 325
    ii_a, jj_a, ss_a = _triplet(n, 300, seed=33)
    ii_b, jj_b, ss_b = _triplet(n, 200, seed=34)
    ai, aj, av = _delta(n, 25, seed=35)
    svc, ref = _services()
    seen = []
    for s, x in ((svc, torch.ones(n)), (ref, jnp.ones(n, jnp.float32))):
        s.assemble(ii_a, jj_a, ss_a, (n, n), cap)   # exec 1: fill A
        B = s.assemble(ii_b, jj_b, ss_b, (n, n))    # exec 2: fill B
        s.spmv(B, x)                                # exec 3: spmv on B
        before = s.stats()["exec"]
        s.update_structure(ii_a, jj_a, ss_a, ai, aj, av, (n, n), cap)
        mid = s.stats()["exec"]
        s.assemble(ii_b, jj_b, ss_b * 3, (n, n))    # B untouched: hits
        s.spmv(B, x)
        after = s.stats()["exec"]
        s.update_structure(ii_a, jj_a, ss_a, ai, aj, av, (n, n), cap)
        seen.append((before, mid, after, s.stats()["exec"]))
    assert seen[0] == seen[1]
    before, mid, after, final = seen[0]
    assert before["size"] == 3 and before["insertions"] == 3
    assert mid["size"] == 3 and mid["evictions"] == 0
    assert mid["insertions"] == before["insertions"] + 1
    assert after["insertions"] == mid["insertions"]
    assert after["hits"] >= mid["hits"] + 2
    assert final["insertions"] == after["insertions"]
    assert final["size"] == 3
    assert svc.stats()["graphs"]["captures"] == {"fill": 3, "spmv": 1}


def test_service_update_retires_spgemm_executables_and_products():
    n, cap = 36, 270
    ii, jj, ss = _triplet(n, 250, seed=36, integer=True)
    kk, ll, tt = _triplet(n, 250, seed=37, integer=True)
    ai, aj, av = _delta(n, 20, seed=38)
    svc = PlanService(device=CPU)
    A = svc.assemble(ii, jj, ss, (n, n), cap)
    B = fsparse(kk, ll, tt, (n, n), device=CPU)
    svc.multiply(A, B)
    assert svc.stats()["exec"]["size"] == 2      # fill A + multiply
    assert product_cache_info()["size"] == 1
    svc.update_structure(ii, jj, ss, ai, aj, av, (n, n), cap)
    assert sorted(k[0] for k, _ in svc._execs.items()) == ["fill"]
    A0 = fsparse(ii, jj, ss, (n, n), nzmax=cap, device=CPU)
    C2 = svc.multiply(A0, B)
    assert product_cache_info()["size"] == 1     # purged, then re-planned
    _same(C2, ops.matmul(A0, B))
    _same(C2, JaxService().multiply(
        jax_fsparse(ii, jj, ss, (n, n), nzmax=cap),
        jax_fsparse(kk, ll, tt, (n, n))))


def test_service_update_retires_persisted_entries(tmp_path):
    n, cap = 32, 216
    ii, jj, ss = _triplet(n, 200, seed=39, integer=True)
    ai, aj, av = _delta(n, 16, seed=40)
    svc = PlanService(cache_dir=tmp_path, device=CPU)
    svc.assemble(ii, jj, ss, (n, n), cap)
    assert len(list(tmp_path.glob("plan-*.pkl"))) == 1
    U = svc.update_structure(ii, jj, ss, ai, aj, av, (n, n), cap)
    # old plan unlinked, updated plan persisted: still exactly one file
    assert len(list(tmp_path.glob("plan-*.pkl"))) == 1
    plan_cache_clear()
    svc2 = PlanService(cache_dir=tmp_path, device=CPU)
    assert svc2.loaded_plans == 1
    U2 = svc2.assemble(np.concatenate([ii, ai]), np.concatenate([jj, aj]),
                       np.concatenate([ss, av]), (n, n), cap)
    _same(U2, U)
    assert plan_cache_info()["misses"] == 0


# ---------------------------------------------------------------------------
# Persistence + warm restart
# ---------------------------------------------------------------------------
def test_persistence_roundtrip_and_warm_restart(tmp_path):
    n = 48
    ii, jj, ss = _triplet(n, 300, seed=8)
    kk, ll, tt = _triplet(n, 300, seed=9)
    A = fsparse(ii, jj, ss, (n, n), device=CPU)
    B = fsparse(kk, ll, tt, (n, n), device=CPU)
    svc = PlanService(cache_dir=tmp_path / "port", device=CPU)
    ref = JaxService(cache_dir=tmp_path / "ref")
    assert svc.loaded_plans == 0 and svc.loaded_products == 0
    S = svc.assemble(ii, jj, ss, (n, n))
    C = svc.multiply(A, B)
    ref.assemble(ii, jj, ss, (n, n))
    ref.multiply(jax_fsparse(ii, jj, ss, (n, n)),
                 jax_fsparse(kk, ll, tt, (n, n)))
    for d in ("port", "ref"):
        assert len(list((tmp_path / d).glob("plan-*.pkl"))) == 1
        assert len(list((tmp_path / d).glob("product-*.pkl"))) == 1
    plan_cache_clear()
    product_cache_clear()
    jax_plan_clear()
    jax_product_clear()
    svc2 = PlanService(cache_dir=tmp_path / "port", device=CPU)
    ref2 = JaxService(cache_dir=tmp_path / "ref")
    assert (svc2.loaded_plans, svc2.loaded_products) == (1, 1)
    assert (ref2.loaded_plans, ref2.loaded_products) == (1, 1)
    _same(svc2.assemble(ii, jj, ss, (n, n)), S)
    _same(svc2.multiply(A, B), C)
    # the restart contract: nothing was re-planned
    assert plan_cache_info()["misses"] == 0
    assert product_cache_info()["misses"] == 0
    # the loaded plan is the planned one, field for field
    key = next(k for k, _ in svc2._execs.items() if k[0] == "fill")[1]
    from repro_torch.sparse.matlab import _PLAN_CACHE

    loaded = _PLAN_CACHE.get(key)
    fresh = plan(torch.from_numpy(ii.astype(np.int32) - 1),
                 torch.from_numpy(jj.astype(np.int32) - 1), (n, n),
                 method=key[8])
    for f in dataclasses.fields(fresh):
        a, b = getattr(loaded, f.name), getattr(fresh, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_save_caches_flushes_existing_entries(tmp_path):
    n = 32
    ii, jj, ss = _triplet(n, 200, seed=11)
    sparse2(ii, jj, ss, (n, n), device=CPU)   # populate the plan LRU
    assert save_caches(tmp_path) == 1
    plan_cache_clear()
    assert load_caches(tmp_path) == (1, 0)
    _same(sparse2(ii, jj, ss, (n, n), device=CPU),
          fsparse(ii, jj, ss, (n, n), device=CPU))
    assert plan_cache_info()["misses"] == 0


def test_save_caches_skips_symmetric_plans(tmp_path):
    rows, cols, vals = find(_formats(8)["csc"][0])
    sparse2(rows, cols, vals, (8, 8), device=CPU, format="symcsc")
    assert plan_cache_info()["size"] == 1
    assert save_caches(tmp_path) == 0


def test_corrupt_cache_entry_degrades_to_replan(tmp_path):
    n = 32
    ii, jj, ss = _triplet(n, 200, seed=12)
    svc = PlanService(cache_dir=tmp_path, device=CPU)
    svc.assemble(ii, jj, ss, (n, n))
    (tmp_path / "plan-deadbeef.pkl").write_bytes(b"not a pickle")
    (tmp_path / "plan-feedface.pkl").write_bytes(
        pickle.dumps({"wrong": "schema"}))
    plan_cache_clear()
    with pytest.warns(CacheCorruptionWarning,
                      match="unreadable plan-cache entry"):
        svc2 = PlanService(cache_dir=tmp_path, device=CPU)
    assert svc2.loaded_plans == 1      # the good entry still loads
    _same(svc2.assemble(ii, jj, ss, (n, n)),
          fsparse(ii, jj, ss, (n, n), device=CPU))


def test_tampered_entry_is_rejected_by_the_validators(tmp_path):
    n = 32
    ii, jj, ss = _triplet(n, 200, seed=13)
    PlanService(cache_dir=tmp_path, device=CPU).assemble(ii, jj, ss, (n, n))
    (path,) = tmp_path.glob("plan-*.pkl")
    payload = pickle.loads(path.read_bytes())
    perm = payload["value"].perm.copy()
    perm[0] = perm[1]                  # no longer a permutation
    payload["value"] = dataclasses.replace(payload["value"], perm=perm)
    path.write_bytes(pickle.dumps(payload, protocol=4))
    plan_cache_clear()
    with pytest.warns(CacheCorruptionWarning,
                      match="invalid plan-cache entry"):
        svc = PlanService(cache_dir=tmp_path, device=CPU)
    assert svc.loaded_plans == 0
    _same(svc.assemble(ii, jj, ss, (n, n)),
          fsparse(ii, jj, ss, (n, n), device=CPU))
    assert plan_cache_info()["misses"] == 1   # re-planned


def test_service_save_requires_cache_dir():
    with pytest.raises(ValueError, match="no cache_dir"):
        PlanService(device=CPU).save()


def test_service_save_writes_every_entry(tmp_path):
    n = 24
    ii, jj, ss = _triplet(n, 100, seed=14)
    svc = PlanService(cache_dir=tmp_path, device=CPU)
    sparse2(ii, jj, ss, (n, n), device=CPU)   # planned outside the service
    assert not list(tmp_path.glob("plan-*.pkl"))
    assert svc.save() == 1
    assert len(list(tmp_path.glob("plan-*.pkl"))) == 1


# ---------------------------------------------------------------------------
# Runtime env helpers, re-exports, stats
# ---------------------------------------------------------------------------
def test_apply_runtime_env_sets_only_what_is_absent(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--xla_foo=1")
    monkeypatch.delenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                       raising=False)
    applied = apply_runtime_env()
    assert applied == runtime_env()
    assert "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" in applied
    assert os.environ["XLA_FLAGS"] == "--xla_foo=1"   # not torch's
    assert apply_runtime_env() == {}                  # idempotent
    monkeypatch.setenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "7")
    assert apply_runtime_env() == {}
    assert os.environ["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "7"


def test_runtime_env_is_the_references_minus_its_xla_knobs():
    from repro.sparse.serving import runtime_env as jax_runtime_env

    want = {k: v for k, v in jax_runtime_env().items()
            if k not in ("XLA_FLAGS", "TF_CPP_MIN_LOG_LEVEL")}
    assert runtime_env() == want


def test_tcmalloc_hint_shape(monkeypatch):
    monkeypatch.setenv("LD_PRELOAD", "/usr/lib/libtcmalloc.so.4")
    assert tcmalloc_hint() is None     # already preloaded
    monkeypatch.setenv("LD_PRELOAD", "")
    hint = tcmalloc_hint()
    assert hint is None or hint.startswith("LD_PRELOAD=")


def test_enable_compilation_cache_takes_nothing(tmp_path):
    assert enable_compilation_cache(tmp_path / "xla") is False
    assert not (tmp_path / "xla").exists()


def test_serve_namespace_reexports_the_sparse_serving_api():
    import repro_torch.serve as serve

    model_half = {"decode_step", "init_cache", "prefill"}
    want = sorted(set(jax_serve.__all__) - model_half)
    assert sorted(serve.__all__) == want
    for name in want:
        assert getattr(serve, name) is getattr(serving, name)


def test_stats_hold_every_reference_key(tmp_path):
    svc = PlanService(cache_dir=tmp_path / "a", device=CPU)
    ref = JaxService(cache_dir=tmp_path / "b")
    st, st_ref = svc.stats(), ref.stats()
    assert set(st_ref) <= set(st)
    for k in ("loaded_plans", "loaded_products", "loaded_tuning_entries",
              "persisted"):
        assert st[k] == st_ref[k] == 0
    assert st["cache_dir"] == str(tmp_path / "a")
    for k in ("size", "capacity", "hits", "misses", "evictions",
              "insertions"):
        assert k in st["plan"] and k in st["product"]


def test_tuning_table_persists_beside_the_caches(tmp_path):
    """A measured table saved by ``save`` is loaded by the next service
    on the same ``cache_dir``, and its fingerprint keys the graphs."""
    from repro_torch.sparse import tuning
    from repro_torch.sparse.tuning.measure import policy_key

    table = tuning.TuningTable()
    tuning.set_table(table)
    try:
        table.record("counting_sort", {"min_block_b": 1 << 15},
                     backend="cpu", **policy_key(
                         "counting_sort", {"nbins": 1001, "L": 10_000}))
        fp = tuning.tuning_fingerprint()
        assert fp != "prior"
        PlanService(cache_dir=tmp_path, device=CPU).save()
        assert (tmp_path / tuning.TABLE_FILENAME).is_file()
        tuning.set_table(tuning.TuningTable())
        svc = PlanService(cache_dir=tmp_path, device=CPU)
        assert svc.loaded_tuning_entries == 1
        assert svc.stats()["tuning_fingerprint"] == fp
        ii, jj, ss = _triplet(20, 50, seed=18)
        svc.assemble(ii, jj, ss, (20, 20))
        (ekey, _), = svc._execs.items()
        assert ekey[-1] == fp
    finally:
        tuning.reset_table()


def test_service_hits_pass_the_contract_audit():
    """A hit dispatches no host synchronisation (on the card the audit
    also flags a copy to the host: an unmemoised key would be one)."""
    from repro_torch.sparse.analysis.contracts import (audit_trace,
                                                       record_ops)

    n = 32
    fmts = {f: port for f, (port, _) in _formats(n).items()}
    ii, jj, ss = _triplet(n, 200, seed=19)
    svc = PlanService(device=CPU)
    x = torch.ones(n)
    A = fmts["csc"]
    paths = {"assemble": lambda: svc.assemble(ii, jj, ss, (n, n)).data,
             "multiply": lambda: svc.multiply(A, A).data,
             **{f"spmv[{f}]": (lambda S=S: svc.spmv(S, x))
                for f, S in fmts.items()}}
    for name, fn in paths.items():
        fn()
        assert audit_trace(record_ops(fn), name=name)["ok"]


def test_exec_capacity_evicts_and_env_overrides(monkeypatch):
    n = 20
    svc = PlanService(device=CPU, exec_capacity=1)
    for seed in (15, 16):
        ii, jj, ss = _triplet(n, 60, seed=seed)
        svc.assemble(ii, jj, ss, (n, n))
    assert svc.stats()["exec"]["evictions"] == 1
    monkeypatch.setenv("REPRO_EXEC_CACHE_SIZE", "5")
    assert PlanService(device=CPU).stats()["exec"]["capacity"] == 5


# ---------------------------------------------------------------------------
# The spmv key memo
# ---------------------------------------------------------------------------
def test_structure_key_memo_hits_and_follows_in_place_writes():
    S = _formats(16)["csc"][0]
    memo = _IdentityMemo()
    k1 = _memo_structure_key(memo, S)
    assert k1 == _structure_key(S)
    assert _memo_structure_key(memo, S) is k1   # a hit: no host copy
    S.indices[0] = S.indices[0] + 0      # an in-place write bumps _version
    k2 = _memo_structure_key(memo, S)
    assert k2 == k1 and k2 is not k1     # recomputed (same bytes here)
    S.indices[-1] = 0
    assert _memo_structure_key(memo, S) != k1
    T = dataclasses.replace(S, indptr=S.indptr.clone())
    assert _memo_structure_key(memo, T) is not \
        _memo_structure_key(memo, S)     # another indptr: not a hit
    assert len(memo) == 1
    del S, T, k1, k2
    import gc

    gc.collect()
    assert len(memo) == 0                # dropped with the tensor


def test_requests_reuse_one_key_object_per_plan(tmp_path):
    """A hot request compares its executable's key by identity: the
    service keeps the first key it saw for each plan object, and one
    digest a persisted plan."""
    n = 24
    ii, jj, ss = _triplet(n, 100, seed=17)
    svc = PlanService(cache_dir=tmp_path, device=CPU)
    for k in (1, 2, 3):
        svc.assemble(ii, jj, ss * k, (n, n))
    (ekey, _), = svc._execs.items()
    key, pat, _ = plan_lookup(ii, jj, ss, (n, n), device=CPU)
    assert svc._plan_key(key, pat) is ekey[1] and key is not ekey[1]
    assert len(svc._plan_memo) == len(svc._digest_memo) == 1
    assert svc.stats()["persisted"] == 1


def test_spmv_entry_keeps_its_own_structure():
    S = _formats(16)["csc"][0]
    x = torch.arange(16, dtype=torch.float32)
    svc = PlanService(device=CPU)
    y = svc.spmv(S, x)
    T = dataclasses.replace(S, indices=S.indices.clone())
    S.indices[:] = S.indices.flip(0)     # the caller rewrites its copy
    np.testing.assert_array_equal(_np(svc.spmv(T, x)), _np(y))
    assert svc.stats()["exec"]["hits"] == 1


# ---------------------------------------------------------------------------
# The capture audit
# ---------------------------------------------------------------------------
def test_audit_retraces_on_cpu():
    assert audit_retraces(device=CPU) == {"name": "retrace", "traces": 2,
                                          "ok": True}


def test_retrace_auditor_counts_as_the_reference():
    rows, cols = np.array([0, 1, 1, 2]), np.array([0, 0, 1, 2])
    pat = plan(torch.from_numpy(rows), torch.from_numpy(cols), (3, 3))
    pat_j = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (3, 3))
    port, ref = RetraceAuditor(), JaxAuditor()
    fill = port.instrument(lambda p, v: p.scatter(v))
    fill_j = ref.instrument(lambda p, v: p.scatter(v))
    steps = [(0, 1.0, 4), (0, 2.0, 4), (1, 1.0, 4), (1, 3.0, 4),
             (0, 1.0, 4)]
    for epoch, scale, L in steps:
        v = np.arange(1, L + 1, dtype=np.float32) * scale
        got = fill(dataclasses.replace(pat, epoch=epoch), torch.from_numpy(v))
        want = fill_j(dataclasses.replace(pat_j, epoch=epoch),
                      jnp.asarray(v))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        assert port.count == ref.count
    assert port.count == 2
    port.expect(2)
    with pytest.raises(InvariantViolation, match="retrace-count"):
        port.expect(3)
    port.reset()
    assert port.count == 0


def test_executable_on_cpu_runs_eagerly_and_returns_fresh_results():
    ex = Executable(lambda a, b: a + 2 * b, [torch.ones(3), torch.ones(3)],
                    kind="t")
    assert ex.graph is None
    y1 = ex(torch.ones(3), torch.full((3,), 2.0))
    y2 = ex(torch.zeros(3), torch.zeros(3))
    assert y1.tolist() == [5.0] * 3 and y2.tolist() == [0.0] * 3
