"""Dynamic patterns of the port against the JAX package.

The merge search (B7's plain version and the registry), ``SparsePattern
.update`` (bit-identical to a fresh ``plan`` of the concatenated
triplets for every sort backend, with and without drops and padding
sentinels, and to the reference's own ``update``), its capacity rule
and one-time warning, chained epochs, and ``plan_update``/
``sparse2_update`` moving plan-cache entries and retiring dependent
products.  Inputs come from numpy seeds; the reference runs
``merge_method="jnp"`` and ``"pallas"`` (interpret mode), the port its
plain versions on the CPU.

Reference tests with no counterpart here, and why:

- the jit-retrace and pytree tests (``tests/test_update.py``, the
  ``epoch`` static-field and ``RetraceAuditor`` ones): torch is eager,
  so there is nothing to retrace; ``epoch`` is a plain int that is
  still bumped and propagated (``test_update_chained_epochs``);
- the residency-fallback test: the port's merge search has no VMEM
  guard (B7 serves every size);
- the sharded rejections other than ``plan_update``'s: they are held
  with the sharded path in ``tests/test_torch_sharded.py``.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.sparse import dispatch as jax_dispatch
from repro.sparse import matlab as jax_matlab
from repro.sparse.pattern import _reset_update_fallback_warning as jax_reset
from repro.sparse.pattern import plan as jax_plan
from repro_torch.kernels.merge import merge as merge_mod
from repro_torch.kernels.merge.ref import merge_search_ref, search_steps
from repro_torch.sparse import (PlanUpdate, fsparse, plan, plan_cache_clear,
                                plan_cache_info, plan_lookup, plan_update,
                                product_cache_clear, product_cache_info,
                                product_lookup, sparse2, sparse2_update)
from repro_torch.sparse.dispatch import (available_merge_methods,
                                         default_merge_method, merge_search)
from repro_torch.sparse.errors import CapacityWarning
from repro_torch.sparse.lru import LRUCache
from repro_torch.sparse.pattern import _reset_update_fallback_warning

torch.set_num_threads(1)

METHODS = ("jnp", "fused", "pallas", "radix")
FIELDS = ("perm", "slot", "indices", "indptr", "srows", "scols")


@pytest.fixture(autouse=True)
def _fresh_state():
    for clear in (plan_cache_clear, product_cache_clear,
                  _reset_update_fallback_warning, jax_reset,
                  jax_matlab.plan_cache_clear):
        clear()
    yield
    for clear in (plan_cache_clear, product_cache_clear,
                  _reset_update_fallback_warning, jax_reset,
                  jax_matlab.plan_cache_clear):
        clear()


def _stream(M, N, L, seed=0, pad_frac=0.0):
    """Random zero-offset int32 indices, optionally with ``row == M``
    padding sentinels mixed in."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    if pad_frac:
        idx = rng.choice(L, max(1, int(L * pad_frac)), replace=False)
        rows[idx] = M
    return rows, cols


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plan(rows, cols, shape, **kw):
    return plan(_t(rows), _t(cols), shape, **kw)


def _assert_same_pattern(got, want, msg=""):
    """Every int32 field equal; ``want`` is a port or a JAX pattern."""
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            err_msg=f"{msg}: {f}")
    assert int(got.nnz) == int(want.nnz), msg
    assert got.nzmax == want.nzmax and got.shape == tuple(want.shape), msg


# ---------------------------------------------------------------------------
# merge search: plain version and registry against searchsorted and the
# reference's backends
# ---------------------------------------------------------------------------
def _targets(M, N, n, Lq, seed):
    rng = np.random.default_rng(seed)
    tr = rng.integers(0, M + 1, n).astype(np.int32)
    tc = rng.integers(0, N, n).astype(np.int32)
    key = tc.astype(np.int64) * (M + 2) + tr
    order = np.argsort(key, kind="stable")
    tr, tc, key = tr[order], tc[order], key[order]
    qr = rng.integers(0, M + 1, Lq).astype(np.int32)
    qc = rng.integers(0, N, Lq).astype(np.int32)
    return tr, tc, key, qr, qc, qc.astype(np.int64) * (M + 2) + qr


@pytest.mark.parametrize("merge_method", ["jnp", "pallas"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_merge_search_matches_searchsorted_and_reference(merge_method, side):
    tr, tc, key, qr, qc, qkey = _targets(50, 40, 700, 333, seed=1)
    want = np.searchsorted(key, qkey, side=side).astype(np.int32)
    got = merge_search(_t(qr), _t(qc), _t(tr), _t(tc), side=side,
                       method=merge_method)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ref = jax_dispatch.merge_search(
        jnp.asarray(qr), jnp.asarray(qc), jnp.asarray(tr), jnp.asarray(tc),
        side=side, method=merge_method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", ["ties", "sentinels", "n1", "ragged"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_merge_search_edge_cases(case, side):
    """Queries equal to targets, sentinel rows, one target, and a query
    count that is no multiple of B7's block: the plain version equals
    searchsorted and the kernel wrapper's CPU path equals it too."""
    M = 9
    if case == "ties":
        tr, tc, key, _, _, _ = _targets(M, 6, 40, 1, seed=2)
        qr, qc = tr[::3].copy(), tc[::3].copy()
    elif case == "sentinels":
        tr, tc, key, qr, qc, _ = _targets(M, 6, 40, 25, seed=3)
        qr[::2] = M
    elif case == "n1":
        tr, tc = np.array([4], np.int32), np.array([2], np.int32)
        qr = np.array([3, 4, 5, 4, M], np.int32)
        qc = np.array([2, 2, 2, 1, 3], np.int32)
    else:
        tr, tc, key, qr, qc, _ = _targets(M, 6, 97,
                                          merge_mod.BLOCK_Q + 3, seed=4)
    key = tc.astype(np.int64) * (M + 2) + tr
    qkey = qc.astype(np.int64) * (M + 2) + qr
    want = np.searchsorted(key, qkey, side=side).astype(np.int32)
    for fn in (merge_search_ref, merge_mod.merge_search_kernel):
        got = fn(_t(qr), _t(qc), _t(tr), _t(tc), side=side)
        np.testing.assert_array_equal(got.numpy(), want)


def test_search_steps_matches_reference():
    from repro.kernels.merge.ref import search_steps as jax_steps

    for n in (0, 1, 2, 3, 4, 1023, 1024, 2**20 + 1):
        assert search_steps(n) == jax_steps(n)


@pytest.mark.parametrize("merge_method", ["jnp", "pallas"])
def test_merge_search_empty_streams(merge_method):
    z = torch.zeros(0, dtype=torch.int32)
    t = torch.tensor([1, 2], dtype=torch.int32)
    assert merge_search(z, z, t, t, method=merge_method).shape == (0,)
    got = merge_search(t, t, z, z, method=merge_method)
    assert torch.equal(got, torch.zeros(2, dtype=torch.int32))


def test_merge_search_unknown_method_and_side():
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown merge method"):
        merge_search(z, z, z, z, method="nope")
    with pytest.raises(ValueError, match="side must be 'left' or 'right'"):
        merge_search(z, z, z, z, side="middle")


def test_merge_registry_names_and_device_default():
    assert available_merge_methods() == \
        jax_dispatch.available_merge_methods()
    assert default_merge_method("cpu") == "jnp"
    assert default_merge_method("cuda") == "pallas"
    assert default_merge_method() == "pallas"


# ---------------------------------------------------------------------------
# update: bit-identical to a fresh plan of the concatenated stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("merge_method", ["jnp", "pallas"])
def test_update_bit_identical_every_backend(method, merge_method):
    M, N, L, Ld = 37, 29, 400, 60
    rows, cols = _stream(M, N, L, seed=3, pad_frac=0.05)
    ar, ac = _stream(M, N, Ld, seed=4, pad_frac=0.05)
    base = _plan(rows, cols, (M, N), method=method, nzmax_slack=Ld)
    got = base.update(ar, ac, method=method, merge_method=merge_method)
    want = _plan(np.concatenate([rows, ar]), np.concatenate([cols, ac]),
                 (M, N), nzmax=base.nzmax, method=method)
    _assert_same_pattern(got, want, f"{method}/{merge_method}")
    assert got.epoch == 1 and base.epoch == 0
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (M, N),
                   method="jnp", nzmax_slack=Ld).update(
        ar, ac, merge_method=merge_method)
    _assert_same_pattern(got, ref, "against the reference's update")
    assert ref.epoch == got.epoch


@pytest.mark.parametrize("method", METHODS)
def test_update_with_drops_bit_identical(method):
    M, N, L, Ld = 31, 23, 350, 40
    rows, cols = _stream(M, N, L, seed=5, pad_frac=0.03)
    ar, ac = _stream(M, N, Ld, seed=6)
    rng = np.random.default_rng(7)
    dm = np.zeros(L, bool)
    dm[rng.choice(L, 80, replace=False)] = True
    base = _plan(rows, cols, (M, N), method=method, nzmax_slack=Ld)
    got = base.update(ar, ac, drop_mask=dm, method=method)
    keep = ~dm
    want = _plan(np.concatenate([rows[keep], ar]),
                 np.concatenate([cols[keep], ac]),
                 (M, N), nzmax=base.nzmax, method=method)
    _assert_same_pattern(got, want, method)
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (M, N),
                   nzmax_slack=Ld).update(ar, ac, drop_mask=dm)
    _assert_same_pattern(got, ref, "against the reference's update")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_update_drops_only_bit_identical(as_tensor):
    M, N, L = 20, 20, 150
    rows, cols = _stream(M, N, L, seed=8)
    dm = np.zeros(L, bool)
    dm[::3] = True
    base = _plan(rows, cols, (M, N))
    empty = np.zeros(0, np.int32)
    args = (empty, empty, dm)
    if as_tensor:
        args = tuple(_t(a) for a in args)
    got = base.update(*args)
    keep = ~dm
    _assert_same_pattern(got, _plan(rows[keep], cols[keep], (M, N),
                                    nzmax=base.nzmax))


def test_update_drops_everything_gives_the_empty_plan():
    rows, cols = _stream(6, 5, 30, seed=9)
    base = _plan(rows, cols, (6, 5))
    got = base.update(np.zeros(0, np.int32), np.zeros(0, np.int32),
                      drop_mask=np.ones(30, bool))
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (6, 5)).update(
        np.zeros(0, np.int32), np.zeros(0, np.int32),
        drop_mask=np.ones(30, bool))
    _assert_same_pattern(got, ref)
    assert got.L == 0 and int(got.nnz) == 0 and got.epoch == 1


@pytest.mark.parametrize("shape,L", [((8, 6), 0), ((0, 6), 12), ((8, 0), 12)])
def test_update_of_a_trivial_base_is_a_plain_plan(shape, L):
    rows, cols = _stream(max(shape[0], 1), max(shape[1], 1), L, seed=10)
    ar, ac = _stream(max(shape[0], 1), max(shape[1], 1), 9, seed=11)
    base = _plan(rows, cols, shape, nzmax_slack=9)
    got = base.update(ar, ac)
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), shape,
                   nzmax_slack=9).update(ar, ac)
    _assert_same_pattern(got, ref)
    assert got.epoch == 1


def test_update_assemble_matches_fsparse_with_duplicates():
    """Duplicates that straddle the base/delta boundary accumulate as a
    one-shot fsparse of the concatenation does."""
    ii = np.array([1, 2, 2, 3])
    jj = np.array([1, 1, 1, 2])
    ss = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    ai = np.array([2, 1, 3])
    aj = np.array([1, 1, 2])
    av = np.array([10.0, 20.0, 30.0], np.float32)
    base = _plan(ii - 1, jj - 1, (3, 2), nzmax_slack=3)
    upd = base.update(ai - 1, aj - 1)
    got = upd.assemble(_t(np.concatenate([ss, av])))
    want = fsparse(np.concatenate([ii, ai]), np.concatenate([jj, aj]),
                   np.concatenate([ss, av]), (3, 2), nzmax=base.nzmax,
                   device="cpu")
    assert torch.equal(got.data, want.data)
    assert torch.equal(got.indptr, want.indptr)


def test_update_chained_epochs():
    """Two successive updates: the structure keeps matching the fresh
    plan and the epoch counts both rewrites."""
    M = N = 25
    rows, cols = _stream(M, N, 200, seed=9)
    a1r, a1c = _stream(M, N, 30, seed=10)
    a2r, a2c = _stream(M, N, 30, seed=11)
    base = _plan(rows, cols, (M, N), nzmax_slack=60)
    p1 = base.update(a1r, a1c)
    p2 = p1.update(a2r, a2c)
    assert (base.epoch, p1.epoch, p2.epoch) == (0, 1, 2)
    want = _plan(np.concatenate([rows, a1r, a2r]),
                 np.concatenate([cols, a1c, a2c]), (M, N),
                 nzmax=base.nzmax)
    _assert_same_pattern(p2, want)


def test_update_keeps_accum():
    rows, cols = _stream(7, 7, 40, seed=12)
    base = _plan(rows, cols, (7, 7), accum="max", nzmax_slack=5)
    assert base.update(*_stream(7, 7, 5, seed=13)).accum == "max"


def test_update_empty_is_a_noop():
    rows, cols = _stream(7, 7, 40, seed=14)
    base = _plan(rows, cols, (7, 7))
    empty = np.zeros(0, np.int32)
    assert base.update(empty, empty) is base
    assert base.update(empty, empty, drop_mask=np.zeros(40, bool)) is base
    assert base.epoch == 0


def test_update_validates_inputs_as_the_reference():
    base = _plan(np.zeros(4, np.int32), np.zeros(4, np.int32), (2, 2))
    ref = jax_plan(jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32), (2, 2))
    cases = [
        ((np.zeros((2, 2), np.int32), np.zeros(4, np.int32)), {}),
        ((np.zeros(0, np.int32), np.zeros(0, np.int32)),
         {"drop_mask": np.zeros(3, bool)}),
    ]
    for args, kw in cases:
        with pytest.raises(ValueError) as mine:
            base.update(*args, **kw)
        with pytest.raises(ValueError) as theirs:
            ref.update(*args, **kw)
        assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# capacity: fallback warning, retained headroom, explicit nzmax
# ---------------------------------------------------------------------------
def test_update_fallback_warns_once_and_matches_full_replan():
    M = N = 22
    rows, cols = _stream(M, N, 120, seed=12)
    ar, ac = _stream(M, N, 30, seed=13)
    base = _plan(rows, cols, (M, N))          # no headroom: L == nzmax
    with pytest.warns(CapacityWarning, match="nzmax_slack"):
        got = base.update(ar, ac)
    want = _plan(np.concatenate([rows, ar]), np.concatenate([cols, ac]),
                 (M, N), nzmax=got.nzmax)
    _assert_same_pattern(got, want)
    assert got.epoch == 1 and got.nzmax == 150
    with warnings.catch_warnings():       # one-time: the second is silent
        warnings.simplefilter("error")
        got2 = base.update(ar, ac)
    _assert_same_pattern(got2, want)


def test_update_fallback_preserves_headroom():
    """A slack-planned pattern that outgrows its slack re-plans with the
    same headroom, so the next delta merges again."""
    M = N = 18
    rows, cols = _stream(M, N, 100, seed=14)
    base = _plan(rows, cols, (M, N), nzmax_slack=10)
    ar, ac = _stream(M, N, 25, seed=15)      # 25 > 10: fallback
    with pytest.warns(RuntimeWarning):
        p1 = base.update(ar, ac)
    assert p1.nzmax == 125 + 10              # L_new + retained headroom
    br, bc = _stream(M, N, 8, seed=16)       # 8 <= 10: merge path again
    _reset_update_fallback_warning()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p2 = p1.update(br, bc)
    assert p2.nzmax == p1.nzmax


def test_update_explicit_nzmax_wins_no_warning():
    M = N = 15
    rows, cols = _stream(M, N, 80, seed=17)
    ar, ac = _stream(M, N, 20, seed=18)
    base = _plan(rows, cols, (M, N))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = base.update(ar, ac, nzmax=150)
    assert got.nzmax == 150
    _assert_same_pattern(got, _plan(np.concatenate([rows, ar]),
                                    np.concatenate([cols, ac]), (M, N),
                                    nzmax=150))


# ---------------------------------------------------------------------------
# first / irank, LRUCache.pop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nzmax", [None, 9, 1])
def test_first_and_irank_match_reference(nzmax):
    rows, cols = _stream(11, 8, 90, seed=19, pad_frac=0.1)
    mine = _plan(rows, cols, (11, 8), nzmax=nzmax)
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (11, 8),
                   nzmax=nzmax)
    assert mine.first.dtype == torch.bool
    np.testing.assert_array_equal(mine.first.numpy(), np.asarray(ref.first))
    np.testing.assert_array_equal(mine.irank().numpy(),
                                  np.asarray(ref.irank()))


def test_lru_pop_retires_without_counting():
    c = LRUCache(4)
    c.insert("a", 1)
    assert c.pop("a") == 1 and c.pop("a", "gone") == "gone"
    info = c.info()
    assert (info["size"], info["evictions"], info["hits"]) == (0, 0, 0)


# ---------------------------------------------------------------------------
# plan_update / sparse2_update through the plan cache
# ---------------------------------------------------------------------------
def _mat(M, L, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, M + 1, L), rng.integers(1, M + 1, L),
            rng.integers(-9, 10, L).astype(np.float32))


def test_plan_update_moves_cache_entry():
    M, L, Ld = 26, 220, 24
    ii, jj, ss = _mat(M, L, 26)
    ai, aj, av = _mat(M, Ld, 27)
    res = plan_update(ii, jj, ss, ai, aj, av, (M, M), nzmax_slack=Ld,
                      device="cpu")
    assert isinstance(res, PlanUpdate)
    assert res.key != res.old_key and res.pattern.epoch == 1
    assert plan_cache_info()["size"] == 1   # old entry popped, new in
    # the new entry answers a plain sparse2 call over the concatenated
    # stream at the updated capacity, with no re-plan
    S = sparse2(np.concatenate([ii, ai]), np.concatenate([jj, aj]),
                np.concatenate([ss, av]), (M, M), nzmax=res.pattern.nzmax,
                device="cpu")
    info = plan_cache_info()
    assert (info["hits"], info["size"]) == (1, 1)
    assert torch.equal(S.data, res.pattern.assemble(res.coo.vals).data)
    ref = jax_matlab.plan_update(ii, jj, ss, ai, aj, av, (M, M),
                                 nzmax_slack=Ld, method="jnp")
    _assert_same_pattern(res.pattern, ref.pattern)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(res.coo, f).numpy(),
                                      np.asarray(getattr(ref.coo, f)))


def test_plan_update_keys_collide_with_sparse2():
    M, L = 18, 120
    ii, jj, ss = _mat(M, L, 35)
    key, pat, _ = plan_lookup(ii, jj, ss, (M, M), nzmax=L + 8, device="cpu")
    ai, aj, av = _mat(M, 8, 36)
    res = plan_update(ii, jj, ss, ai, aj, av, (M, M), nzmax=L + 8,
                      device="cpu")
    assert res.old_key == key and res.old_pattern is pat
    assert plan_cache_info()["hits"] == 1


def test_plan_update_noop_returns_same_entry():
    M, L = 16, 100
    ii, jj, ss = _mat(M, L, 28)
    res = plan_update(ii, jj, ss, [], [], [], (M, M), device="cpu")
    assert res.pattern is res.old_pattern and res.key == res.old_key
    assert plan_cache_info()["size"] == 1


def test_plan_update_rejects_sharded():
    args = ([1], [1], [1.0], [2], [2], [2.0], (4, 4))
    with pytest.raises(ValueError, match="sharded") as mine:
        plan_update(*args, method="sharded", device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_matlab.plan_update(*args, method="sharded")
    assert str(mine.value) == str(theirs.value)


def test_plan_update_delta_out_of_range_raises():
    with pytest.raises(ValueError, match="exceeds matrix dimensions"):
        plan_update([1], [1], [1.0], [9], [1], [2.0], (4, 4), device="cpu")


@pytest.mark.parametrize("drops", [0, 15])
def test_sparse2_update_matches_fsparse_and_reference(drops):
    M, L, Ld = 24, 200, 30
    ii, jj, ss = _mat(M, L, 29)
    ai, aj, av = _mat(M, Ld, 30)
    rng = np.random.default_rng(31)
    dm = np.zeros(L, bool)
    dm[rng.choice(L, drops, replace=False)] = True
    got = sparse2_update(ii, jj, ss, ai, aj, av, (M, M), drop_mask=dm,
                         nzmax_slack=Ld, device="cpu")
    keep = ~dm
    want = fsparse(np.concatenate([ii[keep], ai]),
                   np.concatenate([jj[keep], aj]),
                   np.concatenate([ss[keep], av]), (M, M),
                   nzmax=got.data.shape[0], device="cpu")
    ref = jax_matlab.sparse2_update(ii, jj, ss, ai, aj, av, (M, M),
                                    drop_mask=dm, nzmax_slack=Ld)
    for f in ("data", "indices", "indptr", "nnz"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_plan_update_retires_dependent_products():
    """The SpGEMM cache drops product plans whose operand structure was
    rewritten, lazily, at the next product lookup."""
    M, L = 20, 150
    ii, jj, ss = _mat(M, L, 32)
    kk, ll, tt = _mat(M, L, 33)
    A = fsparse(ii, jj, ss, (M, M), nzmax=L + 16, device="cpu")
    B = fsparse(kk, ll, tt, (M, M), device="cpu")
    product_lookup(A, B)
    assert product_cache_info()["size"] == 1
    ai, aj, av = _mat(M, 10, 34)
    plan_update(ii, jj, ss, ai, aj, av, (M, M), nzmax=L + 16, device="cpu")
    product_lookup(A, B)            # stale entry purged, the pair re-plans
    info = product_cache_info()
    assert info["size"] == 1 and info["insertions"] == 2


def test_edge_flip_of_the_chip_run_through_sparse2_update():
    """``chip_smoke.py``'s phase 4d edge flip at a small mesh: every
    flipped cell trades the structural pair (v10, v01) for (v00, v11),
    so nnz stays; the port's ``sparse2_update`` equals ``fsparse`` of
    the concatenated stream, the numpy oracle and the reference's
    ``sparse2_update`` bit for bit (the values are dyadic)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.core.oracle import matlab_sparse_oracle

    n = 21
    rows, cols, vals, nv, _, _ = chip_smoke.fem_system(n)
    drop, (ar, ac, av) = chip_smoke.edge_flip(n, np.random.default_rng(0))
    assert drop.shape == rows.shape and int(drop.sum()) == ar.size == 18 * 4
    args = (rows + 1, cols + 1, vals, ar + 1, ac + 1, av, (nv, nv))
    got = sparse2_update(*args, drop_mask=drop, device="cpu")
    keep = ~drop
    ci = np.concatenate([rows[keep], ar])
    cj = np.concatenate([cols[keep], ac])
    cv = np.concatenate([vals[keep], av])
    want = fsparse(ci + 1, cj + 1, cv, (nv, nv), nzmax=got.nzmax,
                   device="cpu")
    ref = jax_matlab.sparse2_update(*args, drop_mask=drop)
    for f in ("data", "indices", "indptr", "nnz"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    pr, ir, jc = matlab_sparse_oracle(ci, cj, cv.astype(np.float64), nv, nv)
    nz = int(got.nnz)
    A = fsparse(rows + 1, cols + 1, vals, (nv, nv), device="cpu")
    assert nz == pr.size == int(A.nnz)
    np.testing.assert_array_equal(got.indices[:nz].numpy(), ir)
    np.testing.assert_array_equal(got.data[:nz].numpy(),
                                  pr.astype(np.float32))
    before = set(zip(*(a + 1 for a in (rows, cols))))
    after = set(zip(ci + 1, cj + 1))
    gained, lost = after - before, before - after
    assert len(gained) == len(lost) == 2 * 4
    for i, j in gained:  # (v00, v11): across the new diagonal
        assert abs(int(i) - int(j)) == n + 2
    for i, j in lost:    # (v10, v01): across the old one
        assert abs(int(i) - int(j)) == n
