"""``sparse2`` and its plan LRU against ``fsparse`` and the JAX package.

A hit must return what ``fsparse`` returns and run no planner; the key
must tell apart every request the reference's key tells apart, and also
a CPU plan from a CUDA plan over the same triplets (the port's own
point).  The LRU itself must count as the reference's does.
"""
import sys
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.ransparse import dataset
from repro.launch.mesh import make_data_mesh as jax_mesh
from repro.sparse import lru as jax_lru
from repro.sparse import matlab as jax_matlab
from repro_torch.kernels.radix_sort import radix_sort as rs
from repro_torch.kernels.segment_sum import segment_sum as ss
from repro_torch.sparse import matlab
from repro_torch.sparse.errors import InvariantViolation
from repro_torch.sparse.lru import LRUCache, env_capacity

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _empty_cache():
    matlab.plan_cache_clear()
    yield
    matlab.plan_cache_clear()


def _same(A, B):
    for f in ("data", "indices", "indptr", "nnz"):
        np.testing.assert_array_equal(np.asarray(getattr(A, f)),
                                      np.asarray(getattr(B, f)), err_msg=f)


@pytest.mark.parametrize("method", [None, "fused", "radix", "pallas"])
@pytest.mark.parametrize("k", [1, 3])
def test_sparse2_equals_fsparse_and_reference(k, method):
    ii, jj, _, siz = dataset(k, scale=0.005)
    vals = np.random.default_rng(k).integers(-9, 10, ii.shape[0]) * 1.0
    first = matlab.sparse2(ii, jj, vals, (siz, siz), method=method,
                           device="cpu")
    again = matlab.sparse2(ii, jj, vals, (siz, siz), method=method,
                           device="cpu")
    want = matlab.fsparse(ii, jj, vals, (siz, siz), method=method,
                          device="cpu")
    for got in (first, again):
        _same(got, want)
    _same(first, jax_matlab.sparse2(ii, jj, vals, (siz, siz),
                                    method="fused"))
    info = matlab.plan_cache_info()
    assert (info["misses"], info["hits"], info["size"]) == (1, 1, 1)


def test_a_hit_runs_no_planner_and_refills_new_values():
    ii, jj, ss_, siz = dataset(2, scale=0.005)
    before = (rs.digit_block_histogram.launches, rs.digit_placement.launches,
              ss.gather_segment_sum.launches)
    matlab.sparse2(ii, jj, ss_, (siz, siz), device="cpu")
    key, pat, _ = matlab.plan_lookup(ii, jj, 2 * ss_, (siz, siz),
                                     device="cpu")
    assert matlab.plan_cache_info()["hits"] == 1
    S = matlab.sparse2(ii, jj, 3 * ss_, (siz, siz), device="cpu")
    assert matlab.plan_cache_info()["hits"] == 2
    np.testing.assert_array_equal(
        S.data.numpy(),
        matlab.fsparse(ii, jj, 3 * ss_, (siz, siz), device="cpu").data.numpy())
    assert key[-2] == "cpu" and pat.accum == "sum"
    # the CPU path launches nothing, hit or miss
    assert (rs.digit_block_histogram.launches, rs.digit_placement.launches,
            ss.gather_segment_sum.launches) == before


def test_a_hit_moves_only_the_values(monkeypatch):
    """The indices go to the device inside the planner call, which a hit
    skips; the lookup hands back the values alone."""
    rng = np.random.default_rng(2)
    ii, jj = rng.integers(1, 21, 80), rng.integers(1, 21, 80)
    vals = rng.standard_normal(80)
    planned = []
    real_plan = matlab.plan
    monkeypatch.setattr(matlab, "plan",
                        lambda rows, cols, *a, **k: planned.append(
                            (rows, cols)) or real_plan(rows, cols, *a, **k))
    for s in (vals, 2 * vals):
        _, pat, v = matlab.plan_lookup(ii, jj, s, (20, 20), device="cpu")
        assert torch.equal(v, torch.from_numpy(s.astype(np.float32)))
    assert len(planned) == 1 and matlab.plan_cache_info()["hits"] == 1
    rows, cols = planned[0]
    assert rows.tolist() == (ii - 1).tolist() and rows.dtype == torch.int32
    assert cols.tolist() == (jj - 1).tolist()
    _same(pat.assemble(v), matlab.fsparse(ii, jj, 2 * vals, (20, 20),
                                          device="cpu"))


@pytest.mark.parametrize("change", [
    {"accum": "max"}, {"nzmax": 60}, {"method": "jnp"},
    {"shape": (40, 41)},
])
def test_each_part_of_the_request_is_in_the_key(change):
    rng = np.random.default_rng(0)
    ii, jj = rng.integers(1, 31, 50), rng.integers(1, 31, 50)
    base = dict(shape=(40, 40), device="cpu")
    matlab.sparse2(ii, jj, 1.0, **base)
    matlab.sparse2(ii, jj, 1.0, **dict(base, **change))
    info = matlab.plan_cache_info()
    assert (info["misses"], info["hits"], info["size"]) == (2, 0, 2)


def test_nzmax_slack_folds_into_the_key():
    rng = np.random.default_rng(1)
    ii, jj = rng.integers(1, 11, 40), rng.integers(1, 11, 40)
    A = matlab.sparse2(ii, jj, 1.0, nzmax_slack=5, device="cpu")
    B = matlab.sparse2(ii, jj, 1.0, nzmax=45, device="cpu")
    assert A.nzmax == B.nzmax == 45
    assert matlab.plan_cache_info()["hits"] == 1
    R = jax_matlab.sparse2(ii, jj, 1.0, nzmax_slack=5)
    assert R.nzmax == 45


def test_key_holds_dtypes_shapes_and_the_device():
    r32 = np.arange(8, dtype=np.int32)
    r64 = r32.view(np.int64)  # the same bytes, half as many indices
    c32 = np.zeros(8, np.int32)
    c64 = c32.view(np.int64)
    key = matlab._cache_key
    args = ((8, 8), None, "fused")
    assert r32.tobytes() == r64.tobytes()
    assert key(r32, c32, *args, "cpu") != key(r64, c64, *args, "cpu")
    grid = np.arange(6, dtype=np.int32)
    assert key(grid.reshape(2, 3), grid.reshape(2, 3), *args, "cpu") != \
        key(grid.reshape(3, 2), grid.reshape(3, 2), *args, "cpu")
    assert key(r32, c32, *args, "cpu") != key(r32, c32, *args, "cuda:0")
    assert key(r32, c32, *args, "cpu") == key(r32, c32, *args,
                                              torch.device("cpu"))
    # the reference's key tells the first two apart too
    assert jax_matlab._cache_key(r32, c32, *args) != \
        jax_matlab._cache_key(r64, c64, *args)


@pytest.mark.parametrize("accum", ["sum", "min", "max", "mean", "first",
                                   "last"])
def test_sparse2_duplicate_modes_match_reference(accum):
    rng = np.random.default_rng(2)
    ii, jj = rng.integers(1, 9, 300), rng.integers(1, 8, 300)
    vals = rng.integers(-9, 10, 300).astype(np.float64)
    for _ in range(2):
        S = matlab.sparse2(ii, jj, vals, accum=accum, device="cpu")
    R = jax_matlab.sparse2(ii, jj, vals, accum=accum, method="fused")
    _same(S, R)
    assert matlab.plan_cache_info()["hits"] == 1


@pytest.mark.parametrize("kw", [
    # format="symcsc" is ported (tests/test_torch_symmetric.py),
    # method="sharded" and mesh= too (tests/test_torch_sharded.py)
    pytest.param({"method": "sharded"}, id="kw0-item 14"),
    pytest.param({"mesh": object()}, id="kw2-item 14"),
])
def test_sparse2_rejects_what_fsparse_rejects(kw):
    """``mesh=`` without ``method="sharded"`` is rejected before any plan,
    as ``fsparse`` rejects it; a sharded request plans once and hits."""
    args = ([1, 2, 2], [1, 2, 2], [1.0, 2.0, 4.0])
    if "mesh" in kw:
        with pytest.raises(ValueError) as ref_err:
            jax_matlab.sparse2(*args, **kw)
        with pytest.raises(ValueError) as err:
            matlab.sparse2(*args, device="cpu", **kw)
        assert str(err.value) == str(ref_err.value)
        assert matlab.plan_cache_info()["misses"] == 0
        return
    for _ in range(2):
        S = matlab.sparse2(*args, device="cpu", **kw)
    _same(S, jax_matlab.sparse2(*args, mesh=jax_mesh(1), **kw))
    assert matlab.plan_cache_info()["misses"] == 1
    assert matlab.plan_cache_info()["hits"] == 1


def _drive(cache, ops):
    """One sequence of cache operations; returns the values seen."""
    seen = []
    for op, *args in ops:
        if op == "goc":
            seen.append(cache.get_or_create(args[0], lambda: args[0] * 10))
        elif op == "get":
            seen.append(cache.get(args[0]))
        elif op == "resize":
            cache.resize(args[0])
        elif op == "purge":
            seen.append(cache.purge(lambda k: k % 2 == 0))
    return seen


def test_lru_counts_and_evicts_as_the_reference():
    ops = [("goc", 1), ("goc", 2), ("goc", 3), ("get", 1), ("goc", 4),
           ("get", 2), ("goc", 1), ("resize", 2), ("goc", 6), ("get", 3),
           ("purge",), ("goc", 7), ("get", 6)]
    mine, ref = LRUCache(3, name="a"), jax_lru.LRUCache(3, name="a")
    assert _drive(mine, ops) == _drive(ref, ops)
    assert mine.info() == ref.info()
    assert len(mine) == len(ref) and (7 in mine) == (7 in ref)
    mine.clear()
    assert mine.info()["hits"] == mine.info()["size"] == 0


def test_env_capacity_matches_reference(monkeypatch):
    assert env_capacity(None, 5) == 5
    monkeypatch.setenv("PORT_TEST_CAP", "7")
    assert env_capacity("PORT_TEST_CAP", 5) == 7 == \
        LRUCache(2, env="PORT_TEST_CAP").info()["capacity"]
    for bad in ("x", "0"):
        monkeypatch.setenv("PORT_TEST_CAP", bad)
        with pytest.raises(ValueError) as ref_err:
            jax_lru.env_capacity("PORT_TEST_CAP", 5)
        with pytest.raises(ValueError) as err:
            env_capacity("PORT_TEST_CAP", 5)
        assert str(err.value) == str(ref_err.value)
    with pytest.raises(ValueError):
        LRUCache(0)


def test_sanitizer_flags_planning_under_the_lock():
    cache = LRUCache(4, name="s", sanitize=True)
    with cache._locked():
        with pytest.raises(InvariantViolation) as err:
            cache.get_or_create("k", lambda: 1)
    assert err.value.invariant == "lock-discipline"
    cache.get_or_create("k", lambda: 1)
    with cache._locked():
        assert cache.get("k") == 1
    info = cache.info()
    assert info["lock_sanitize"] and info["lock_reentries"] >= 1


def test_concurrent_misses_share_one_plan():
    """16 threads, 4 structures: no lost entry, one insertion per key,
    every caller of a key gets the same plan object."""
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, 20, 200), rng.integers(1, 20, 200))
            for _ in range(4)]
    got, errors = {}, []

    def worker(t):
        try:
            ii, jj = reqs[t % 4]
            _, pat, _ = matlab.plan_lookup(ii, jj, 1.0, (20, 20),
                                           device="cpu")
            got[t] = pat
        except Exception as e:  # reported below, with the thread
            errors.append((t, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    info = matlab.plan_cache_info()
    assert info["insertions"] == info["size"] == 4
    assert info["hits"] + info["misses"] == 16
    for t in range(4, 16):
        assert got[t] is got[t % 4]
    want = jax_matlab.fsparse(*reqs[0], 1.0, (20, 20), method="fused")
    np.testing.assert_array_equal(got[0].indices.numpy(),
                                  np.asarray(want.indices))
    assert np.asarray(jnp.asarray(want.nnz)) == int(got[0].nnz)
