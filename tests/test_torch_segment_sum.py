"""The port's fused fill (plain B3' on the CPU) against the JAX reference.

The reference ``gather_segment_sum_sorted`` differences a global prefix
sum (Pallas kernel in interpret mode); the port sums each segment
directly.  On integer-valued data both are exact, so they agree bit for
bit.  On random float32 each slot's difference of two prefix sums is
off by at most a few ulps of the running total, bounded here by
``4 * eps_f32 * sum(|v|)`` over the whole stream.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.segment_sum.ops import \
    gather_segment_sum_sorted as jax_gather_segment_sum_sorted
from repro.sparse.pattern import plan as jax_plan
from repro_torch.kernels.segment_sum import ops
from repro_torch.kernels.segment_sum import segment_sum as ss

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _plan(L, M, N, seed):
    """A reference plan with duplicates and padding rows (row == M)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M + 1, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    pat = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (M, N),
                   method="fused")
    return np.array(pat.perm), np.array(pat.slot), int(pat.nnz)


def _both(vals, perm, slot, nzmax):
    got = ops.gather_segment_sum_sorted(
        torch.from_numpy(vals), torch.from_numpy(perm),
        torch.from_numpy(slot), num_segments=nzmax)
    want = jax_gather_segment_sum_sorted(
        jnp.asarray(vals), jnp.asarray(perm), jnp.asarray(slot),
        num_segments=nzmax)
    return got, np.asarray(want)


def _oracle(vals, perm, slot, nzmax):
    keep = slot < nzmax
    return np.bincount(slot[keep], weights=vals[perm[keep]].astype(
        np.float64), minlength=nzmax)


@pytest.mark.parametrize("L,M,N", [(1, 3, 3), (500, 10, 10),
                                   (5000, 60, 40), (20000, 300, 300)])
def test_fill_matches_reference_on_integer_values(L, M, N):
    perm, slot, _ = _plan(L, M, N, L)
    vals = np.random.default_rng(L).integers(-8, 9, L).astype(np.float32)
    got, want = _both(vals, perm, slot, L)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L,M,N", [(500, 10, 10), (20000, 300, 300)])
def test_fill_matches_reference_on_random_values(L, M, N):
    perm, slot, _ = _plan(L, M, N, L + 1)
    vals = np.random.default_rng(L).standard_normal(L).astype(np.float32)
    got, want = _both(vals, perm, slot, L)
    atol = 4 * EPS32 * float(np.abs(vals).sum())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # and the port sums each slot in sorted order: float64 oracle
    mag = _oracle(np.abs(vals), perm, slot, L)
    assert np.all(np.abs(got.numpy() - _oracle(vals, perm, slot, L))
                  <= 4 * EPS32 * mag)


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.9, 1.5])
def test_capacity_below_nnz_drops_every_slot_past_it(frac):
    L, M, N = 3000, 40, 40
    perm, slot, nnz = _plan(L, M, N, 7)
    nzmax = int(frac * nnz)
    vals = np.random.default_rng(2).integers(-8, 9, L).astype(np.float32)
    got, want = _both(vals, perm, slot, nzmax)
    assert got.shape == (nzmax,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  _oracle(vals, perm, slot, nzmax))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_values_accumulate_in_float32(dtype):
    # one slot with 300 duplicates of 1.0: a 16-bit running sum would
    # stop at 256; accumulated in float32 the total is 300 (exact in
    # both 16-bit types)
    L = 300 + 50
    slot = np.concatenate([np.zeros(300), np.arange(1, 51)]).astype(np.int32)
    perm = np.random.default_rng(0).permutation(L).astype(np.int32)
    vals = torch.ones(L, dtype=dtype)
    got = ops.gather_segment_sum_sorted(vals, torch.from_numpy(perm),
                                        torch.from_numpy(slot),
                                        num_segments=51)
    assert got.dtype == dtype
    assert float(got[0]) == 300.0 and torch.all(got[1:] == 1)
    want = jax_gather_segment_sum_sorted(
        jnp.ones(L, jnp.bfloat16 if dtype == torch.bfloat16
                 else jnp.float16),
        jnp.asarray(perm), jnp.asarray(slot), num_segments=51)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def test_integer_values_promote_to_float32():
    perm, slot, _ = _plan(400, 12, 12, 3)
    vals = np.random.default_rng(3).integers(-5, 6, 400).astype(np.int32)
    got, want = _both(vals, perm, slot, 400)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_wide_and_complex_values_on_cpu(dtype):
    perm, slot, _ = _plan(2000, 30, 30, 4)
    rng = np.random.default_rng(4)
    vals = rng.standard_normal(2000).astype(dtype)
    if np.iscomplexobj(vals):
        vals = vals + 1j * rng.standard_normal(2000).astype(np.float32)
    got = ops.gather_segment_sum_sorted(
        torch.from_numpy(vals), torch.from_numpy(perm),
        torch.from_numpy(slot), num_segments=2000).numpy()
    assert got.dtype == vals.dtype
    want = np.zeros(2000, vals.dtype)
    keep = slot < 2000
    np.add.at(want, slot[keep], vals[perm[keep]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_empty_stream_gives_zeros():
    got = ops.gather_segment_sum_sorted(
        torch.zeros(0), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), num_segments=4)
    assert got.tolist() == [0.0] * 4


def test_cpu_tensors_never_launch():
    perm, slot, _ = _plan(100, 5, 5, 0)
    before = ss.gather_segment_sum.launches
    ss.gather_segment_sum(torch.ones(100), torch.from_numpy(perm),
                          torch.from_numpy(slot), num_segments=100)
    assert ss.gather_segment_sum.launches == before
