"""Symmetric and block planning of the port against the JAX package.

The structure detectors (``detect_symmetry``, ``detect_block``, and
``pattern_symmetric`` through the merge search), the halved
``plan_symmetric``/``SymPattern`` plan (its fields, its refill, its
rejects and its gradient), ``format="symcsc"|"bsr"`` through ``fsparse``
and ``sparse2`` (and the plan-cache key), and a ``SymPattern`` made by
the JAX package carried to the port and refilled on both sides.
Integer structure is compared bit for bit; values are integer-valued
(or dyadic), so they are too.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.sparse import matlab as jax_matlab
from repro.sparse import pattern as jax_pattern
from repro_torch.kernels.merge import merge as merge_mod
from repro_torch.sparse import (BSR, CSC, SymCSC, SymPattern, convert,
                                detect_block, detect_symmetry, find, fsparse,
                                nnz_of, pattern_symmetric, plan,
                                plan_cache_clear, plan_cache_info,
                                plan_lookup, plan_symmetric, sparse2,
                                sym_pattern_from_arrays)

from hypothesis_compat import given, settings, st

torch.set_num_threads(1)

UPAT_FIELDS = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")
SYM_FIELDS = ("diag", "data", "indices", "indptr", "nnz")


@pytest.fixture(autouse=True)
def _empty_cache():
    plan_cache_clear()
    yield
    plan_cache_clear()


def _sym_triplets(seed=0, M=16, L=40):
    """Unit-offset symmetrised triplets with integer values that are
    symmetric after duplicate summation."""
    rng = np.random.default_rng(seed)
    r0 = rng.integers(1, M + 1, L)
    c0 = rng.integers(1, M + 1, L)
    v0 = rng.integers(-4, 5, L).astype(np.float32)
    return (np.concatenate([r0, c0]), np.concatenate([c0, r0]),
            np.concatenate([v0, v0]), M)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_fields(mine, ref, fields):
    for f in fields:
        np.testing.assert_array_equal(
            getattr(mine, f).detach().numpy(), np.asarray(getattr(ref, f)),
            err_msg=f)


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------
def test_detect_symmetry_basic():
    ii, jj, _, M = _sym_triplets()
    assert detect_symmetry(ii - 1, jj - 1, (M, M))
    assert detect_symmetry(_t(ii - 1), _t(jj - 1), (M, M))
    assert not detect_symmetry(ii - 1, jj - 1, (M, M + 1))
    assert detect_symmetry(np.array([], int), np.array([], int), (4, 4))


def test_detect_symmetry_one_missing_mirror():
    r = np.array([0, 1, 0])
    c = np.array([1, 0, 2])  # (0, 2) has no (2, 0)
    assert not detect_symmetry(r, c, (3, 3))
    assert detect_symmetry(np.append(r, 2), np.append(c, 0), (3, 3))
    # a sentinel row never counts, with or without its mirror
    assert detect_symmetry(np.append(r, [2, 3]), np.append(c, [0, 1]),
                           (3, 3))


@pytest.mark.parametrize("seed", range(6))
def test_detectors_match_reference_on_random_streams(seed):
    rng = np.random.default_rng(seed)
    M = int(rng.integers(2, 12)) * 2
    L = int(rng.integers(1, 80))
    r, c = rng.integers(0, M + 1, L), rng.integers(0, M, L)
    if seed % 2:
        r, c = np.concatenate([r, c]), np.concatenate([c, r])
    for shape in ((M, M), (M, M + 2)):
        assert detect_symmetry(r, c, shape) == \
            jax_pattern.detect_symmetry(r, c, shape)
        assert detect_block(r, c, shape) == \
            jax_pattern.detect_block(r, c, shape)


def test_detect_block():
    b = 2
    br = np.repeat(np.array([0, 1, 3]), b * b) * b + np.tile(
        np.repeat(np.arange(b), b), 3)
    bc = np.repeat(np.array([1, 0, 2]), b * b) * b + np.tile(
        np.tile(np.arange(b), b), 3)
    assert detect_block(br, bc, (8, 8)) == 2
    assert detect_block(_t(br), _t(bc), (8, 8)) == 2
    assert detect_block(br[:-1], bc[:-1], (8, 8)) == 1
    assert detect_block(np.array([0, 5]), np.array([3, 1]), (8, 8)) == 1
    assert detect_block(np.array([], int), np.array([], int), (8, 8)) == 1


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_property_symmetrized_streams_detected(data):
    M = data.draw(st.integers(2, 24))
    L = data.draw(st.integers(1, 60))
    r0 = data.draw(st.lists(st.integers(0, M - 1), min_size=L, max_size=L))
    c0 = data.draw(st.lists(st.integers(0, M - 1), min_size=L, max_size=L))
    r = np.concatenate([np.array(r0), np.array(c0)])
    c = np.concatenate([np.array(c0), np.array(r0)])
    assert detect_symmetry(r, c, (M, M))
    assert pattern_symmetric(plan(_t(r), _t(c), (M, M)))


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_property_one_flip_breaks_detection(data):
    M = data.draw(st.integers(4, 24))
    L = data.draw(st.integers(1, 40))
    r0 = data.draw(st.lists(st.integers(0, M - 1), min_size=L, max_size=L))
    c0 = data.draw(st.lists(st.integers(0, M - 1), min_size=L, max_size=L))
    r = np.concatenate([np.array(r0), np.array(c0)])
    c = np.concatenate([np.array(c0), np.array(r0)])
    occupied = set(zip(r.tolist(), c.tolist()))
    extra = next(((i, j) for i in range(M) for j in range(M)
                  if i != j and (i, j) not in occupied
                  and (j, i) not in occupied), None)
    if extra is None:  # the stream is already dense: nothing to break
        return
    r2, c2 = np.append(r, extra[0]), np.append(c, extra[1])
    assert not detect_symmetry(r2, c2, (M, M))
    assert not pattern_symmetric(plan(_t(r2), _t(c2), (M, M)))


def test_pattern_symmetric_on_plans():
    ii, jj, _, M = _sym_triplets()
    r, c = (ii - 1).astype(np.int32), (jj - 1).astype(np.int32)
    sym = plan(_t(r), _t(c), (M, M))
    assert pattern_symmetric(sym)
    assert jax_pattern.pattern_symmetric(
        jax_pattern.plan(jnp.asarray(r), jnp.asarray(c), (M, M)))
    asym = plan(_t(np.array([0, 1, 0])), _t(np.array([1, 0, 2])), (3, 3))
    assert not pattern_symmetric(asym)
    rect = plan(_t(r), _t(c), (M, M + 1))
    assert not pattern_symmetric(rect)
    empty = plan(_t(np.full(3, M)), _t(np.zeros(3, int)), (M, M))
    assert pattern_symmetric(empty)


def test_pattern_symmetric_with_padding_and_duplicates():
    """Sentinels and repeats in the planned stream: only the
    first-flagged valid keys are probed, as in the reference."""
    ii, jj, _, M = _sym_triplets(seed=3, M=12, L=30)
    r = np.concatenate([ii - 1, [M, M], ii[:5] - 1]).astype(np.int32)
    c = np.concatenate([jj - 1, [0, 3], jj[:5] - 1]).astype(np.int32)
    mine = plan(_t(r), _t(c), (M, M), nzmax_slack=4)
    ref = jax_pattern.plan(jnp.asarray(r), jnp.asarray(c), (M, M),
                           nzmax_slack=4)
    assert pattern_symmetric(mine) == jax_pattern.pattern_symmetric(ref)
    assert pattern_symmetric(mine)


# ---------------------------------------------------------------------------
# the halved plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["fused", "radix", "pallas"])
def test_plan_symmetric_matches_reference_and_halves_the_plan(method):
    ii, jj, vv, M = _sym_triplets(seed=5, M=20, L=60)
    r, c = (ii - 1).astype(np.int32), (jj - 1).astype(np.int32)
    spat = plan_symmetric(r, c, (M, M), method=method, device="cpu")
    ref = jax_pattern.plan_symmetric(r, c, (M, M), method="jnp")
    assert isinstance(spat, SymPattern)
    assert spat.L == ref.L and spat.shape == tuple(ref.shape)
    _same_fields(spat.upat, ref.upat, UPAT_FIELDS)
    _same_fields(spat, ref, ("usel", "dsel", "drow"))
    assert spat.nzmax == ref.nzmax and spat.epoch == 0
    assert int(spat.nnz) == int(ref.nnz)
    full = plan(_t(r), _t(c), (M, M))
    assert 2 * spat.nzmax <= full.nzmax + M
    Y = spat.assemble(_t(vv))
    assert isinstance(Y, SymCSC)
    assert torch.equal(Y.to_dense(), full.assemble(_t(vv)).to_dense())
    _same_fields(Y, ref.assemble(jnp.asarray(vv)), SYM_FIELDS)


def test_plan_symmetric_follows_the_tensor_device():
    ii, jj, vv, M = _sym_triplets(seed=6)
    spat = plan_symmetric(_t(ii - 1), _t(jj - 1), (M, M))
    assert spat.upat.perm.device.type == "cpu"
    assert spat.usel.device.type == "cpu"


def test_plan_symmetric_rejects_as_the_reference():
    cases = [
        ((np.array([0, 1, 0]), np.array([1, 0, 2]), (3, 3)), {},
         ValueError),
        ((np.array([0]), np.array([0]), (2, 3)), {}, ValueError),
        ((np.array([0, 1]), np.array([1, 0]), (2, 2)), {"accum": "max"},
         NotImplementedError),
    ]
    for args, kw, exc in cases:
        with pytest.raises(exc) as mine:
            plan_symmetric(*args, device="cpu", **kw)
        with pytest.raises(exc) as theirs:
            jax_pattern.plan_symmetric(*args, **kw)
        assert str(mine.value) == str(theirs.value)
        assert "plan()" in str(mine.value)


def test_sympattern_assemble_rejects_a_wrong_length():
    ii, jj, vv, M = _sym_triplets(seed=7)
    spat = plan_symmetric(ii - 1, jj - 1, (M, M), device="cpu")
    with pytest.raises(ValueError, match="length-80 value vector"):
        spat.assemble(_t(vv[:-1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_sympattern_fill_dtype(dtype):
    ii, jj, vv, M = _sym_triplets(seed=8)
    spat = plan_symmetric(ii - 1, jj - 1, (M, M), device="cpu")
    Y = spat.assemble(_t(vv).to(dtype))
    assert Y.diag.dtype == dtype and Y.data.dtype == dtype
    want = plan(_t(ii - 1), _t(jj - 1), (M, M)).assemble(
        _t(vv).to(dtype)).to_dense()
    assert torch.equal(Y.to_dense(), want)


def test_sympattern_shared_parameter_grad_matches_dense_and_reference():
    """The gradient for a shared upstream parameter agrees with the
    full plan's, though the halved fill reads only half the stream."""
    ii, jj, vv, M = _sym_triplets(seed=14, M=10, L=25)
    r, c = ii - 1, jj - 1
    spat = plan_symmetric(r, c, (M, M), device="cpu")
    full = plan(_t(r), _t(c), (M, M))
    t0 = np.random.default_rng(6).normal(size=1).astype(np.float32)
    base = _t(vv)

    def grad(pat):
        t = torch.tensor(t0, requires_grad=True)
        (pat.assemble(base * t).to_dense() ** 2).sum().backward()
        return t.grad

    g_sym, g_full = grad(spat), grad(full)
    torch.testing.assert_close(g_sym, g_full, rtol=1e-5, atol=1e-5)
    ref = jax_pattern.plan_symmetric(r, c, (M, M))
    g_ref = jax.grad(lambda t: jnp.sum(
        ref.assemble(jnp.asarray(vv) * t).to_dense() ** 2))(jnp.asarray(t0))
    np.testing.assert_allclose(g_sym.numpy(), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-5)


def test_carried_reference_sympattern_refills_on_both_sides():
    ii, jj, vv, M = _sym_triplets(seed=9, M=18, L=50)
    ref = jax_pattern.plan_symmetric(ii - 1, jj - 1, (M, M))
    fields = {k: np.asarray(getattr(ref.upat, k)) for k in UPAT_FIELDS}
    fields.update({k: np.asarray(getattr(ref, k))
                   for k in ("usel", "dsel", "drow")})
    mine = sym_pattern_from_arrays(fields, ref.shape, ref.L, device="cpu")
    v = np.random.default_rng(10).integers(-7, 8, vv.size).astype(
        np.float32)
    v = np.concatenate([v[:vv.size // 2], v[:vv.size // 2]])  # symmetric
    _same_fields(mine.assemble(_t(v)), ref.assemble(jnp.asarray(v)),
                 SYM_FIELDS)


# ---------------------------------------------------------------------------
# the Matlab facade: format=, the plan cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", [None, "fused", "pallas"])
def test_fsparse_format_symcsc(method):
    ii, jj, vv, M = _sym_triplets(seed=15)
    S = fsparse(ii, jj, vv, (M, M), device="cpu")
    Y = fsparse(ii, jj, vv, (M, M), format="symcsc", method=method,
                device="cpu")
    assert isinstance(Y, SymCSC)
    assert torch.equal(Y.to_dense(), S.to_dense())
    _same_fields(Y, jax_matlab.fsparse(ii, jj, vv, (M, M), format="symcsc"),
                 SYM_FIELDS)
    # the stored part equals the conversion of the full matrix
    C = convert(S, "symcsc")
    nz = int(C.nnz)
    assert int(Y.nnz) == nz and torch.equal(Y.diag, C.diag)
    assert torch.equal(Y.data[:nz], C.data) \
        and torch.equal(Y.indices[:nz], C.indices)
    assert torch.equal(Y.indptr, C.indptr)
    assert nnz_of(Y) == 2 * int(Y.nnz) + M
    ri, ci, vi = find(Y)
    De = np.zeros((M, M), np.float32)
    De[ri - 1, ci - 1] = vi
    np.testing.assert_array_equal(De, S.to_dense().numpy())


@pytest.mark.parametrize("block", [1, 2, 4])
def test_fsparse_format_bsr(block):
    ii, jj, vv, M = _sym_triplets(seed=16, M=16)
    B = fsparse(ii, jj, vv, (M, M), format="bsr", block=block, device="cpu")
    assert isinstance(B, BSR) and B.block == block
    S = fsparse(ii, jj, vv, (M, M), device="cpu")
    want = convert(S, "bsr", block=block)
    for f in ("data", "indices", "indptr", "nnz"):
        assert torch.equal(getattr(B, f), getattr(want, f)), f
    ref = jax_matlab.fsparse(ii, jj, vv, (M, M), format="bsr", block=block)
    _same_fields(B, ref, ("data", "indices", "indptr", "nnz"))


def test_fsparse_format_validation_as_the_reference():
    cases = [dict(format="ell"), dict(block=0),
             dict(format="symcsc", block=2)]
    for kw in cases:
        with pytest.raises(ValueError) as mine:
            fsparse([1], [1], [1.0], (2, 2), device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            jax_matlab.fsparse([1], [1], [1.0], (2, 2), **kw)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="not pairwise symmetric"):
        fsparse([1, 1], [1, 2], [1.0, 2.0], (2, 2), format="symcsc",
                device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        fsparse([1], [1], [1.0], (2, 2), method="sharded", format="symcsc",
                device="cpu")


def test_sparse2_format_in_cache_key():
    ii, jj, vv, M = _sym_triplets(seed=16, M=14, L=35)
    A1 = sparse2(ii, jj, vv, (M, M), format="symcsc", device="cpu")
    A2 = sparse2(ii, jj, 2 * vv, (M, M), format="symcsc", device="cpu")
    assert plan_cache_info()["hits"] == 1
    assert isinstance(A1, SymCSC) and isinstance(A2, SymCSC)
    assert torch.equal(A2.to_dense(), 2 * A1.to_dense())
    _, pat, _ = plan_lookup(ii, jj, vv, (M, M), format="symcsc",
                            device="cpu")
    assert isinstance(pat, SymPattern)
    # the plain plan and the BSR plan are other entries, not collisions
    Ap = sparse2(ii, jj, vv, (M, M), device="cpu")
    Ab = sparse2(ii, jj, vv, (M, M), format="bsr", block=2, device="cpu")
    assert isinstance(Ap, CSC) and isinstance(Ab, BSR)
    assert plan_cache_info()["size"] == 3
    for A in (Ap, Ab):
        assert torch.equal(A.to_dense(), A1.to_dense())


def test_sparse2_bsr_format():
    A = sparse2(np.array([1, 3]), np.array([1, 3]), np.array([2.0, 5.0]),
                (4, 4), format="bsr", block=2, device="cpu")
    assert isinstance(A, BSR) and A.block == 2
    want = np.zeros((4, 4), np.float32)
    want[0, 0], want[2, 2] = 2.0, 5.0
    np.testing.assert_array_equal(A.to_dense().numpy(), want)


def test_pattern_symmetric_counts_no_launch_on_the_cpu():
    """On the CPU the merge search runs B7's plain version: the launch
    counter moves only where the kernel runs."""
    ii, jj, _, M = _sym_triplets(seed=17)
    before = merge_mod.merge_search_kernel.launches
    assert pattern_symmetric(plan(_t(ii - 1), _t(jj - 1), (M, M)))
    assert merge_mod.merge_search_kernel.launches == before
