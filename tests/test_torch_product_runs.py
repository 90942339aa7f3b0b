"""B6 on the product streams that break a tile design, on the CPU.

The product fill (``csrc/segment_sum.cu``, ``gather2_segment_sum``) is
B3''s single-pass segmented reduction with two gathers a position: it
reduces each run of equal slots across tiles of ``PRODUCT_TILE``
positions and carries the run open at a tile's end through a look-back.
The streams that test that design are built by
``chip_smoke.product_stream`` (``ragged_slots``' runs, here with one
run of 2^14 where the card's tests take 2^20, and ``sa``/``sb`` random
into two operand vectors) and ``chip_smoke.arrow_gram`` (``B' B`` of the
arrow matrix: its dense column gives one run); the card's tests
(``test_torch_gpu.py``) hold the kernel against its plain version on
them.  Here, on the CPU: the port's ``gather2_segment_sum_sorted`` (its
plain version) against the JAX package's, through the interpret-mode
Pallas kernel, bit for bit on integer-valued float32 and float64 data,
and with a NaN against the JAX package's plain reference (the Pallas
route differences a global prefix sum, so a NaN reaches every later
slot there); the streams' run contract; the exact per-slot sums the
card's tests measure errors against; and B6's one zeroed allocation of
output and look-back scratch at its tile size.
"""
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_sum.ops import \
    gather2_segment_sum_sorted as jax_gather2
from repro.kernels.segment_sum.ref import \
    gather2_segment_sum_sorted_ref as jax_gather2_ref
from repro_torch.kernels.segment_sum import segment_sum as ss
from repro_torch.kernels.segment_sum.ops import gather2_segment_sum_sorted
from repro_torch.kernels.segment_sum.ref import (PRODUCT_TILE,
                                                 gather2_segment_sum_ref)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke.py at the repo root
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

KINDS = chip_smoke.PRODUCT_KINDS
DROPPED = 2**30  # ragged_slots' dropped slot past every num_segments
LONG = 1 << 14   # the long run here (2^20 on the card)
OPERANDS = 1 << 12


def _stream(kind, seed=7):
    rng = np.random.default_rng(seed)
    sa, sb, slot = chip_smoke.product_stream(kind, PRODUCT_TILE, rng,
                                             OPERANDS, long_run=LONG)
    nnz = int(slot[slot < DROPPED].max()) + 1
    return rng, sa, sb, slot, nnz


def _jax_slot(slot):
    # the reference masks slot >= num_segments only: a dropped -1 is
    # masked there as the port masks it
    return jnp.asarray(np.where(slot < 0, DROPPED, slot))


@pytest.mark.parametrize("kind", KINDS)
def test_product_streams_keep_the_kernels_run_contract(kind):
    """Kept slots are 0, 1, ... in stream order, each one run of adjacent
    positions; sa and sb index the operand vectors."""
    _, sa, sb, slot, nnz = _stream(kind)
    assert sa.dtype == sb.dtype == slot.dtype == np.int32
    assert sa.shape == sb.shape == slot.shape
    assert sa.min() >= 0 and sb.min() >= 0
    assert sa.max() < OPERANDS and sb.max() < OPERANDS
    kept = slot[(slot >= 0) & (slot < DROPPED)]
    assert np.array_equal(np.unique(kept), np.arange(nnz))
    pos = np.flatnonzero((slot >= 0) & (slot < DROPPED))
    runs = np.split(pos, np.flatnonzero(np.diff(kept) != 0) + 1)
    assert all(r[-1] - r[0] + 1 == r.size for r in runs)


def test_product_streams_meet_the_tile_edges():
    T = PRODUCT_TILE
    _, _, _, slot, _ = _stream("tile_edge")
    run = np.flatnonzero(slot == slot[T - 1])
    assert (run[0], run[-1]) == (T - 1, 3 * T - 1)
    _, _, _, slot, _ = _stream("dropped_tile")
    dropped = np.flatnonzero((slot < 0) | (slot >= DROPPED))
    assert dropped[0] < 4 * T and dropped[-1] >= 5 * T - 1
    _, _, _, slot, _ = _stream("one_run")
    counts = np.bincount(slot)
    start = int(np.flatnonzero(slot == counts.argmax())[0])
    assert counts.max() == LONG and start % T != 0
    # the card's long run is LONG_RUN, by default
    slot = chip_smoke.ragged_slots("one_run", T, np.random.default_rng(0))
    assert np.bincount(slot).max() == chip_smoke.LONG_RUN


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_product_fill_matches_reference_kernel_on_ragged_streams(kind, dtype,
                                                                 cut):
    """The port's B6 (plain version) against the JAX package's
    interpret-mode Pallas ``gather2_masked_cumsum`` route, bit for bit on
    integer-valued data, num_segments at nnz and cut mid-stream.  The
    reference runs in float32 (no x64 here); integer sums below 2^24 are
    exact in both types."""
    rng, sa, sb, slot, nnz = _stream(kind)
    n = nnz // 2 if cut else nnz
    va, vb = (rng.integers(-8, 9, OPERANDS).astype(dtype) for _ in range(2))
    got = gather2_segment_sum_sorted(
        torch.from_numpy(va), torch.from_numpy(vb), torch.from_numpy(sa),
        torch.from_numpy(sb), torch.from_numpy(slot), num_segments=n)
    want = np.asarray(jax_gather2(
        jnp.asarray(va.astype(np.float32)), jnp.asarray(vb.astype(np.float32)),
        jnp.asarray(sa), jnp.asarray(sb), _jax_slot(slot), num_segments=n,
        interpret=True))
    assert got.dtype == torch.from_numpy(va).dtype
    np.testing.assert_array_equal(got.numpy(), want.astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_product_fill_with_a_nan_matches_reference(kind, dtype):
    """A NaN among integer-valued operands stays in the slots whose
    products reach it, bit for bit against the JAX package's plain
    reference (``jax.ops.segment_sum``)."""
    rng, sa, sb, slot, nnz = _stream(kind)
    va, vb = (rng.integers(-8, 9, OPERANDS).astype(dtype) for _ in range(2))
    kept = np.flatnonzero((slot >= 0) & (slot < DROPPED))
    va[sa[kept[kept.size // 2]]] = np.nan
    got = gather2_segment_sum_sorted(
        torch.from_numpy(va), torch.from_numpy(vb), torch.from_numpy(sa),
        torch.from_numpy(sb), torch.from_numpy(slot), num_segments=nnz)
    want = np.asarray(jax_gather2_ref(
        jnp.asarray(va.astype(np.float32)), jnp.asarray(vb.astype(np.float32)),
        jnp.asarray(sa), jnp.asarray(sb), _jax_slot(slot),
        num_segments=nnz)).astype(dtype)
    assert np.isnan(got.numpy()).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_arrow_gram_has_one_run_of_its_dense_column():
    """B' B of the arrow matrix: the host's product count matches the
    plan's, and the dense column's dot product with itself is one run
    of ``dense`` products; the port's fill of it against the JAX
    package's plain reference, bit for bit on integer-valued data."""
    dense = 1 << 10
    rng = np.random.default_rng(3)
    pp, Bt, B = chip_smoke.arrow_gram("cpu", rng, dense=dense)
    assert pp.flops == chip_smoke.arrow_gram_flops(dense)
    assert chip_smoke.arrow_gram_flops() <= chip_smoke.ARROW_GRAM_MAX_FLOPS
    counts = torch.bincount(pp.pattern.slot.long())
    assert int(counts.max()) == dense
    va, vb = (rng.integers(-8, 9, k).astype(np.float32)
              for k in (Bt.nzmax, B.nzmax))
    st = (pp.sa, pp.sb, pp.pattern.slot)
    got = gather2_segment_sum_sorted(torch.from_numpy(va),
                                     torch.from_numpy(vb), *st,
                                     num_segments=pp.nzmax)
    want = np.asarray(jax_gather2_ref(
        jnp.asarray(va), jnp.asarray(vb), *(jnp.asarray(x.numpy())
                                            for x in st),
        num_segments=pp.nzmax))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_product_errors_are_read_against_fsum(kind, dtype):
    """The card's tests measure B6's error against these sums: the
    rounded products of each slot, summed within eps64 of sum|terms| of
    ``math.fsum``'s correctly rounded sums; a result off by more than
    the tolerance is caught."""
    rng, sa, sb, slot, nnz = _stream(kind)
    va, vb = (torch.from_numpy(rng.standard_normal(OPERANDS).astype(dtype))
              for _ in range(2))
    sa_t, sb_t, slot_t = (torch.from_numpy(x) for x in (sa, sb, slot))
    terms = (va[sa_t.long()] * vb[sb_t.long()]).double().numpy()
    want = np.zeros(nnz)
    kept = (slot >= 0) & (slot < nnz)
    for s in range(nnz):
        want[s] = math.fsum(terms[kept & (slot == s)])
    exact, _ = chip_smoke.exact_segment_sums(torch.from_numpy(terms),
                                            slot_t, nnz)
    eps64 = np.finfo(np.float64).eps
    tmag = np.bincount(slot[kept], np.abs(terms[kept]), nnz)
    assert np.all(np.abs(exact - want) <= eps64 * tmag)
    eps = float(np.finfo(dtype).eps)
    got = gather2_segment_sum_ref(va, vb, sa_t, sb_t, slot_t,
                                  num_segments=nnz)
    assert chip_smoke.product_err_over_eps(got, va, vb, sa_t, sb_t, slot_t,
                                           eps) <= chip_smoke.C_SEG
    off = got.clone()
    s = int(np.argmax(tmag))
    off[s] += 64 * eps * tmag[s]
    assert chip_smoke.product_err_over_eps(off, va, vb, sa_t, sb_t, slot_t,
                                           eps) > chip_smoke.C_SEG


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,L", [(0, 1), (5, PRODUCT_TILE),
                                 (7, PRODUCT_TILE + 1),
                                 (10_000, 1_000_000)])
def test_product_output_and_scratch_share_one_zeroed_allocation(n, L,
                                                                dtype):
    """B6's output and look-back scratch (the ticket, then one descriptor
    a tile of PRODUCT_TILE positions) are cut from one zeroed buffer."""
    out, scratch = ss._zeros_and_scratch(n, dtype, L, "cpu", PRODUCT_TILE)
    words = 1 + -(-L // PRODUCT_TILE) * (2 if dtype == torch.float32
                                         else 4)
    assert out.shape == (n,) and out.dtype == dtype and out.is_contiguous()
    assert scratch.shape == (words,) and scratch.dtype == torch.int64
    assert out.untyped_storage().data_ptr() == \
        scratch.untyped_storage().data_ptr()
    assert n == 0 or out.data_ptr() >= scratch.data_ptr() + 8 * words
    assert not out.any() and not scratch.any()
