"""The port's duplicate modes (B4 and B5 through their plain versions on
the CPU) against the JAX package.

The reference runs its Pallas kernels in interpret mode.  Min, max,
first and last select one value, so they agree bit for bit on any data,
NaN included; sum and mean agree bit for bit on integer-valued data.
On random float32 the port sums each segment directly where the
reference differences a global prefix sum, so sums agree within
``4 * eps * sum|v|``.  The unfused fill (B5 and ``_segment_totals``)
differences a prefix sum on both sides, taken in other orders: each
prefix is within ``64 * eps`` of the running sum of ``|v|`` (trees of
depth under 64 on both sides), and each slot, a difference of two
prefixes, within twice that.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import assembly_ops as jax_asm
from repro.kernels.segment_sum import ops as jax_ops
from repro.kernels.segment_sum.ref import \
    segment_reduce_sorted_ref as jax_segment_reduce_sorted_ref
from repro.kernels.segment_sum.segment_sum import (
    blocked_cumsum as jax_blocked_cumsum,
    gather_masked_segscan as jax_gather_masked_segscan)
from repro.sparse import matlab as jax_matlab
from repro.sparse.pattern import first_flags as jax_first_flags
from repro.sparse.pattern import plan as jax_plan
from repro_torch.kernels import assembly_ops
from repro_torch.kernels.segment_sum import ops, ref
from repro_torch.kernels.segment_sum import segment_sum as ss
from repro_torch.sparse import matlab
from repro_torch.sparse.pattern import pattern_from_arrays, plan

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
MODES = ("sum", "mean", "min", "max", "first", "last")
FIELDS = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")


def _streams(L, M, N, seed, slack=0):
    """A reference plan with duplicates, padding rows (row == M) and, with
    ``slack``, empty slots past nnz."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M + 1, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    pat = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (M, N),
                   method="fused", nzmax_slack=slack)
    return rows, cols, pat


def _reduce_both(vals, pat, accum, nzmax=None):
    nzmax = pat.nzmax if nzmax is None else nzmax
    perm, slot = np.asarray(pat.perm), np.asarray(pat.slot)
    got = ops.gather_segment_reduce_sorted(
        torch.from_numpy(vals), torch.from_numpy(perm),
        torch.from_numpy(slot), accum=accum, num_segments=nzmax)
    want = jax_ops.gather_segment_reduce_sorted(
        jnp.asarray(vals), jnp.asarray(perm), jnp.asarray(slot),
        accum=accum, num_segments=nzmax)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("accum", MODES)
@pytest.mark.parametrize("L,M,N,slack", [(1, 3, 3, 0), (700, 12, 9, 5),
                                         (6000, 60, 50, 40)])
def test_every_mode_matches_reference_bit_for_bit(accum, L, M, N, slack):
    """Integer values, padding rows, empty tail slots, and one NaN for
    the selections (a NaN in a sum: see the next test)."""
    _, _, pat = _streams(L, M, N, L, slack)
    vals = np.random.default_rng(L).integers(-9, 10, L).astype(np.float32)
    if accum not in ("sum", "mean"):
        vals[L // 2] = np.nan
    got, want = _reduce_both(vals, pat, accum)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if accum in ("min", "max") and L > 1:
        assert np.isnan(got).any() and (got[int(pat.nnz):] == 0).all()


@pytest.mark.parametrize("accum", ["sum", "mean"])
def test_nan_in_a_sum_stays_in_its_slot(accum):
    """The reference's kernel path differences a global prefix sum, so
    one NaN reaches every later slot; the port sums each slot directly
    and matches the reference's own scatter fill, where only the NaN's
    slot is NaN."""
    _, _, pat = _streams(700, 12, 9, 17, 5)
    vals = np.random.default_rng(17).integers(-9, 10, 700).astype(
        np.float32)
    vals[350] = np.nan
    got, kernel_path = _reduce_both(vals, pat, accum)
    want = np.asarray(pat.scatter(jnp.asarray(vals), accum=accum))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).sum() == 1 < np.isnan(kernel_path).sum()


@pytest.mark.parametrize("accum", MODES)
def test_every_mode_on_random_values(accum):
    _, _, pat = _streams(5000, 40, 40, 3, slack=10)
    vals = np.random.default_rng(3).standard_normal(5000).astype(np.float32)
    got, want = _reduce_both(vals, pat, accum)
    if accum in ("sum", "mean"):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=4 * EPS32 * np.abs(vals).sum())
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frac", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("op", ["min", "max"])
def test_min_max_capacity_below_nnz_drops_every_slot_past_it(op, frac):
    _, _, pat = _streams(3000, 30, 30, 8)
    nzmax = int(frac * int(pat.nnz))
    vals = np.random.default_rng(8).standard_normal(3000).astype(np.float32)
    got, want = _reduce_both(vals, pat, op, nzmax)
    assert got.shape == (nzmax,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["min", "max"])
def test_plain_segmented_scan_matches_the_reference_kernel(op):
    _, _, pat = _streams(9000, 50, 50, 4, slack=3)
    perm, slot = np.asarray(pat.perm), np.asarray(pat.slot)
    vals = np.random.default_rng(4).standard_normal(9000).astype(np.float32)
    vals[[10, 4000]] = np.nan
    first = jax_first_flags(jnp.asarray(slot), pat.nzmax)
    want = jax_gather_masked_segscan(
        jnp.asarray(vals), jnp.asarray(perm), jnp.asarray(slot), first,
        num_segments=pat.nzmax, op=op)
    keep = slot < pat.nzmax
    ident = np.float32(np.inf if op == "min" else -np.inf)
    v = torch.from_numpy(np.where(keep, vals[perm], ident))
    got = ref.segmented_scan_ref(v, torch.from_numpy(np.asarray(first)),
                                 op=op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("frac", [0.5, None])
def test_segment_ends_match_reference(frac):
    """Each slot's last sorted position, -1 for empty slots (the tail
    past nnz) and for slots past a capacity below nnz."""
    _, _, pat = _streams(3000, 40, 30, 8, slack=6)
    slot = np.asarray(pat.slot)
    nzmax = pat.nzmax if frac is None else int(frac * int(pat.nnz))
    got = ops._segment_ends(torch.from_numpy(slot), num_segments=nzmax)
    want = jax_ops._segment_ends(jnp.asarray(slot), num_segments=nzmax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("accum", MODES)
def test_plain_scatter_oracle_matches_reference_oracle(accum):
    _, _, pat = _streams(800, 15, 15, 6, slack=4)
    perm, slot = np.asarray(pat.perm), np.asarray(pat.slot)
    vals = np.random.default_rng(6).integers(-5, 6, 800).astype(np.float32)
    got = ref.segment_reduce_sorted_ref(
        torch.from_numpy(vals), torch.from_numpy(perm),
        torch.from_numpy(slot), accum=accum, num_segments=pat.nzmax)
    want = jax_segment_reduce_sorted_ref(
        jnp.asarray(vals), jnp.asarray(perm), jnp.asarray(slot),
        accum=accum, num_segments=pat.nzmax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kernel_path, _ = _reduce_both(vals, pat, accum)
    np.testing.assert_array_equal(got.numpy(), kernel_path)


@pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16),
                                     (torch.float16, jnp.float16)])
@pytest.mark.parametrize("op", ["min", "max"])
def test_16bit_min_max_select_exactly(op, tdt, jdt):
    _, _, pat = _streams(2000, 20, 20, 9)
    perm, slot = np.asarray(pat.perm), np.asarray(pat.slot)
    vals = np.random.default_rng(9).standard_normal(2000).astype(np.float32)
    got = ops.gather_segment_reduce_sorted(
        torch.from_numpy(vals).to(tdt), torch.from_numpy(perm),
        torch.from_numpy(slot), accum=op, num_segments=pat.nzmax)
    want = jax_ops.gather_segment_reduce_sorted(
        jnp.asarray(vals).astype(jdt), jnp.asarray(perm), jnp.asarray(slot),
        accum=op, num_segments=pat.nzmax)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16),
                                     (torch.float16, jnp.float16)])
@pytest.mark.parametrize("accum", ["sum", "mean"])
def test_16bit_sum_and_mean_round_once(accum, tdt, jdt):
    """16-bit streams sum in float32 and are cast back once, after the
    mean's division: the reference's ``SparsePattern`` fill.  The
    port's pattern fill and its kernel-path reduce are one code path."""
    rows, cols, ref_pat = _streams(3000, 12, 10, 18, slack=4)
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (12, 10),
                nzmax_slack=4)
    vals = np.random.default_rng(18).integers(-40, 41, 3000).astype(
        np.float32) / 8
    v = torch.from_numpy(vals).to(tdt)
    got = ops.gather_segment_reduce_sorted(v, mine.perm, mine.slot,
                                           accum=accum,
                                           num_segments=mine.nzmax)
    assert got.dtype == tdt
    assert torch.equal(got, mine.scatter(v, accum=accum))
    want = ref_pat.scatter(jnp.asarray(vals).astype(jdt), accum=accum)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def _kept_runs_adjacent(slot: np.ndarray, num_segments: int) -> bool:
    """Every kept slot value forms one run of adjacent positions."""
    kept = slot < num_segments
    starts = kept & np.r_[True, slot[1:] != slot[:-1]]
    return int(starts.sum()) == np.unique(slot[kept]).size


@pytest.mark.parametrize("extra", [-100, 0, 1, 5])
def test_plan_streams_meet_the_kernels_run_contract(extra):
    """B3' and B4 write each slot from the first position of its run, so
    each kept slot must be one run.  A plan's streams meet that for
    ``num_segments <= nzmax``; above it the dropped inputs' ``nzmax``
    sentinel is kept, and its runs (one per column with padding) are not
    adjacent: that is outside the contract
    (``gather_segment_reduce_sorted``)."""
    _, _, pat = _streams(4000, 30, 25, 19, slack=3)
    slot = np.asarray(pat.slot)
    n = pat.nzmax + extra
    assert _kept_runs_adjacent(slot, n) == (extra <= 0)
    if extra <= 0:
        for accum in MODES:
            vals = np.random.default_rng(19).integers(-9, 10, 4000).astype(
                np.float32)
            got, want = _reduce_both(vals, pat, accum, n)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("length", [2999, 3001])
@pytest.mark.parametrize("fill", ["assemble", "fill_fused", "fill_pallas"])
def test_fills_reject_values_of_another_length(fill, length):
    """The kernels read ``vals[perm[k]]`` unchecked: every fill checks
    the length first, as the reference's ``SparsePattern`` fill does."""
    rows, cols, _ = _streams(3000, 25, 25, 20)
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (25, 25))
    fn = mine.assemble if fill == "assemble" else \
        lambda v: getattr(assembly_ops, fill)(mine, v)
    with pytest.raises(ValueError, match="length-L=3000"):
        fn(torch.ones(length))
    assert fn(torch.ones(3000)).data.shape == (3000,)


def test_fill_fused_is_differentiable():
    rows, cols, ref_pat = _streams(600, 10, 8, 21)
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (10, 8))
    vals = np.random.default_rng(21).standard_normal(600).astype(np.float32)
    w = np.random.default_rng(22).standard_normal(600).astype(np.float32)
    v = torch.from_numpy(vals).requires_grad_()
    (got,) = torch.autograd.grad(
        (assembly_ops.fill_fused(mine, v).data * torch.from_numpy(w)).sum(),
        v)
    want = jax.grad(lambda x: jnp.sum(ref_pat.assemble(x).data * w))(
        jnp.asarray(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_stream_and_complex_min_max():
    z = torch.zeros(0, dtype=torch.int32)
    got = ops.gather_segment_reduce_sorted(torch.zeros(0), z, z, accum="max",
                                           num_segments=3)
    assert got.tolist() == [0.0] * 3
    with pytest.raises(ValueError) as ref_err:
        jax_ops.gather_segment_reduce_sorted(
            jnp.zeros(2, jnp.complex64), jnp.zeros(2, jnp.int32),
            jnp.zeros(2, jnp.int32), accum="min", num_segments=2)
    with pytest.raises(ValueError, match="no total order"):
        ops.gather_segment_reduce_sorted(
            torch.zeros(2, dtype=torch.complex64), z.new_zeros(2),
            z.new_zeros(2), accum="min", num_segments=2)
    assert "no total order" in str(ref_err.value)


@pytest.mark.parametrize("L", [1, 4095, 4097, 10_000, 30_001])
def test_prefix_sum_matches_reference(L):
    rng = np.random.default_rng(L)
    xi = rng.integers(-8, 9, L).astype(np.float32)
    got = ss.blocked_cumsum(torch.from_numpy(xi)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_blocked_cumsum(jnp.asarray(xi))))
    xn = rng.standard_normal(L).astype(np.float32)
    got = ss.blocked_cumsum(torch.from_numpy(xn)).numpy()
    want = np.asarray(jax_blocked_cumsum(jnp.asarray(xn)))
    tol = 64 * EPS32 * np.cumsum(np.abs(xn).astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
    np.testing.assert_allclose(got, np.cumsum(xn.astype(np.float64)),
                               rtol=0, atol=float(tol[-1]))


@pytest.mark.parametrize("L", [4096, 3 * 4096 + 1, 20_000])
def test_prefix_sum_at_the_scan_tile_on_cancelling_data(L):
    """B5's plain version at its tile (``SCAN_TILE``) against the JAX
    scan: a running sum that cancels (+a, -a pairs) within the unchanged
    ``64 eps`` of the running sum of ``|x|``, and integers bit for bit."""
    assert ref.SCAN_TILE == 4096
    rng = np.random.default_rng(L)
    a = rng.standard_normal(L // 2 + 1).astype(np.float32)
    x = np.stack([a, -a], 1).reshape(-1)[:L]
    got = ss.blocked_cumsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_blocked_cumsum(jnp.asarray(x)))
    tol = 64 * EPS32 * np.cumsum(np.abs(x).astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
    xi = rng.integers(-1000, 1001, L).astype(np.float32)
    np.testing.assert_array_equal(
        ss.blocked_cumsum(torch.from_numpy(xi)).numpy(),
        np.asarray(jax_blocked_cumsum(jnp.asarray(xi))))


@pytest.mark.parametrize("slack", [0, 7])
def test_segment_sum_sorted_matches_reference(slack):
    _, _, pat = _streams(6000, 50, 40, 10, slack)
    perm, slot = np.asarray(pat.perm), np.asarray(pat.slot)
    first = np.asarray(jax_first_flags(jnp.asarray(slot), pat.nzmax))
    keep = slot < pat.nzmax
    rng = np.random.default_rng(10)
    for vals, exact in ((rng.integers(-8, 9, 6000), True),
                        (rng.standard_normal(6000), False)):
        v = np.where(keep, vals[perm], 0).astype(np.float32)
        got = ops.segment_sum_sorted(torch.from_numpy(v),
                                     torch.from_numpy(first),
                                     num_segments=pat.nzmax).numpy()
        want = np.asarray(jax_ops.segment_sum_sorted(
            jnp.asarray(v), jnp.asarray(first), num_segments=pat.nzmax))
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(
                got, want, rtol=0, atol=128 * EPS32 * np.abs(v).sum())
    z = torch.zeros(0)
    assert ops.segment_sum_sorted(z, z.bool(), num_segments=2).tolist() \
        == [0.0, 0.0]


def test_fill_pallas_matches_reference_and_oracle():
    rows, cols, ref_pat = _streams(8000, 70, 60, 11, slack=9)
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (70, 60),
                nzmax_slack=9)
    rng = np.random.default_rng(11)
    vi = rng.integers(-8, 9, 8000).astype(np.float32)
    got = assembly_ops.fill_pallas(mine, torch.from_numpy(vi))
    want = jax_asm.fill_pallas(ref_pat, jnp.asarray(vi))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    vn = rng.standard_normal(8000).astype(np.float32)
    got = assembly_ops.fill_pallas(mine, torch.from_numpy(vn)).data.numpy()
    want = np.asarray(jax_asm.fill_pallas(ref_pat, jnp.asarray(vn)).data)
    slot, perm = mine.slot.numpy(), mine.perm.numpy()
    keep = slot < mine.nzmax
    oracle = np.bincount(slot[keep], weights=vn[perm[keep]].astype(
        np.float64), minlength=mine.nzmax)
    # running sum of |v| in sorted order, up to each slot's end
    run = np.cumsum(np.bincount(slot[keep], weights=np.abs(
        vn[perm[keep]]).astype(np.float64), minlength=mine.nzmax))
    assert np.all(np.abs(got - oracle) <= 128 * EPS32 * run)
    assert np.all(np.abs(want - oracle) <= 128 * EPS32 * run)


@pytest.mark.parametrize("accum", MODES)
def test_fill_fused_and_fill_pallas_every_mode_match_reference(accum):
    rows, cols, ref_pat = _streams(3000, 25, 25, 12, slack=3)
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (25, 25),
                nzmax_slack=3)
    vals = np.random.default_rng(12).integers(-9, 10, 3000).astype(
        np.float32)
    want = np.asarray(jax_asm.fill_fused(ref_pat, jnp.asarray(vals),
                                         accum=accum).data)
    for fill in (assembly_ops.fill_fused, assembly_ops.fill_pallas):
        got = fill(mine, torch.from_numpy(vals), accum=accum)
        np.testing.assert_array_equal(got.data.numpy(), want)


@pytest.mark.parametrize("accum", ["min", "max"])
@pytest.mark.parametrize("method", ["fused", "radix", "pallas"])
def test_fsparse_min_max_matches_reference(accum, method):
    rng = np.random.default_rng(13)
    ii = rng.integers(1, 9, 400)
    jj = rng.integers(1, 7, 400)
    vals = rng.standard_normal(400)
    S = matlab.fsparse(ii, jj, vals, accum=accum, method=method, device="cpu")
    R = jax_matlab.fsparse(ii, jj, vals, accum=accum, method="fused")
    np.testing.assert_array_equal(S.data.numpy(), np.asarray(R.data))
    np.testing.assert_array_equal(S.indices.numpy(), np.asarray(R.indices))


@pytest.mark.parametrize("accum", ["min", "max"])
def test_min_max_gradient_matches_jax_grad_with_ties(accum):
    """Values from {-2..2}: most slots have tied extremes, and the
    gradient goes to the first attaining element of each."""
    rng = np.random.default_rng(14)
    M, N, L = 10, 8, 400
    rows = rng.integers(0, M + 1, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    vals = rng.integers(-2, 3, L).astype(np.float32)
    w = rng.standard_normal(L).astype(np.float32)
    ref_pat = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (M, N),
                       accum=accum, method="fused")
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (M, N),
                accum=accum)
    want = jax.grad(lambda v: jnp.sum(ref_pat.assemble(v).data * w))(
        jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    (got,) = torch.autograd.grad(
        (mine.assemble(v).data * torch.from_numpy(w)).sum(), v)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.count_nonzero(got.numpy()) <= int(mine.nnz)


@pytest.mark.parametrize("accum", ["min", "max"])
def test_reference_min_max_plan_carried_into_the_port(accum):
    rows, cols, _ = _streams(2500, 30, 30, 15)
    ref_pat = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (30, 30),
                       accum=accum, method="radix")
    mine = pattern_from_arrays({f: np.asarray(getattr(ref_pat, f))
                                for f in FIELDS}, ref_pat.shape,
                               accum=ref_pat.accum, device="cpu")
    assert mine.accum == accum
    vals = np.random.default_rng(15).standard_normal(2500).astype(np.float32)
    np.testing.assert_array_equal(
        mine.assemble(torch.from_numpy(vals)).data.numpy(),
        np.asarray(ref_pat.assemble(jnp.asarray(vals)).data))
    np.testing.assert_array_equal(
        assembly_ops.fill_fused(mine, torch.from_numpy(vals)).data.numpy(),
        np.asarray(jax_asm.fill_fused(ref_pat, jnp.asarray(vals)).data))


def test_cpu_min_max_never_launch():
    _, _, pat = _streams(500, 9, 9, 16)
    before = (ss.gather_segment_minmax.launches, ss.blocked_cumsum.launches)
    for accum in ("min", "max"):
        ops.gather_segment_reduce_sorted(
            torch.ones(500), torch.from_numpy(np.asarray(pat.perm)),
            torch.from_numpy(np.asarray(pat.slot)), accum=accum,
            num_segments=pat.nzmax)
    ss.blocked_cumsum(torch.ones(10))
    assert (ss.gather_segment_minmax.launches,
            ss.blocked_cumsum.launches) == before
