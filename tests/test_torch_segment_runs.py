"""B3' and B4 on the streams that break a tile design, on the CPU.

The fill kernels (``csrc/segment_sum.cu``) reduce each run of equal
slots across tiles of ``SEG_TILE`` positions and carry the run open at a
tile's end through a look-back.  The streams that test that design are
built by ``chip_smoke.ragged_slots`` (one run of 2^20, runs of random
length 1..10^4, a run that starts at a tile's last position, a tile of
only dropped slots); the card's tests (``test_torch_gpu.py``) hold the
kernels against the plain versions on them.  Here, on the CPU: the
wrappers (their plain versions) against the JAX package's plain
reference on the same streams, bit for bit on integer-valued data and
for min/max with NaNs; the streams' own invariants; the exact per-slot
sums the card's tests measure errors against, against ``math.fsum``;
and the wrappers' shared zeroed allocation and the library hash.
"""
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_sum.ref import \
    segment_reduce_sorted_ref as jax_segment_reduce_sorted_ref
from repro_torch.kernels import common
from repro_torch.kernels.segment_sum import segment_sum as ss
from repro_torch.kernels.segment_sum.ref import SEG_TILE

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke.py at the repo root
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

KINDS = ("one_run", "random", "tile_edge", "dropped_tile")
DROPPED = 2**30  # ragged_slots' dropped slot past every num_segments


def _stream(kind, seed=5):
    rng = np.random.default_rng(seed)
    slot = chip_smoke.ragged_slots(kind, SEG_TILE, rng)
    perm, slot_t = chip_smoke.slot_stream(slot, "cpu", seed)
    nnz = int(slot[slot < DROPPED].max()) + 1
    return rng, slot, perm, slot_t, nnz


@pytest.mark.parametrize("kind", KINDS)
def test_ragged_streams_keep_the_kernels_run_contract(kind):
    """Kept slots are 0, 1, ... in stream order, each one run of adjacent
    positions; perm is a permutation of the positions."""
    _, slot, perm, _, nnz = _stream(kind)
    kept = slot[(slot >= 0) & (slot < DROPPED)]
    assert np.array_equal(np.unique(kept), np.arange(nnz))
    pos = np.flatnonzero((slot >= 0) & (slot < DROPPED))
    starts = np.flatnonzero(np.diff(kept) != 0) + 1
    runs = np.split(pos, starts)
    assert all(r[-1] - r[0] + 1 == r.size for r in runs)
    assert np.array_equal(np.sort(perm.numpy()), np.arange(slot.size))


def test_ragged_streams_meet_the_tile_edges():
    T = SEG_TILE
    _, slot, _, _, _ = _stream("tile_edge")
    run = np.flatnonzero(slot == slot[T - 1])
    assert (run[0], run[-1]) == (T - 1, 3 * T - 1)  # starts at a tile's end
    assert slot[3 * T] != slot[3 * T - 1]           # a tile starts a run
    _, slot, _, _, _ = _stream("dropped_tile")
    dropped = np.flatnonzero((slot < 0) | (slot >= DROPPED))
    assert dropped[0] < 4 * T and dropped[-1] >= 5 * T - 1
    assert dropped.size == dropped[-1] - dropped[0] + 1
    assert {-1, DROPPED} <= set(slot[dropped].tolist())
    _, slot, _, _, _ = _stream("one_run")
    counts = np.bincount(slot)
    start = int(np.flatnonzero(slot == counts.argmax())[0])
    assert counts.max() == chip_smoke.LONG_RUN and start % T != 0


@pytest.mark.parametrize("kind,L", [("long", 5 * chip_smoke.LONG_RUN + 7),
                                    ("random", 123_457)])
def test_run_lengths_cover_exactly_L(kind, L):
    lengths = chip_smoke.run_lengths(L, np.random.default_rng(1), kind)
    assert lengths.sum() == L and lengths.min() >= 1
    top = chip_smoke.LONG_RUN if kind == "long" else 10**4
    assert lengths.max() <= top


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("accum", ["sum", "min", "max"])
@pytest.mark.parametrize("kind", KINDS)
def test_fills_match_reference_on_ragged_streams(kind, accum, cut):
    """The port's B3' (integer-valued data) and B4 (random data with
    NaNs) against the JAX package's plain reference, bit for bit, with
    num_segments at nnz and cut mid-stream."""
    rng, _, perm, slot, nnz = _stream(kind)
    n = nnz // 2 if cut else nnz
    L = slot.shape[0]
    if accum == "sum":
        vals = rng.integers(-8, 9, L).astype(np.float32)
        got = ss.gather_segment_sum(torch.from_numpy(vals), perm, slot,
                                    num_segments=n)
    else:
        vals = rng.standard_normal(L).astype(np.float32)
        vals[[3, L // 2, L - 1]] = np.nan
        got = ss.gather_segment_minmax(torch.from_numpy(vals), perm, slot,
                                       num_segments=n, op=accum)
    # the reference masks slot >= num_segments; a dropped -1 is masked
    # here as the port masks it
    jslot = np.where(slot.numpy() < 0, DROPPED, slot.numpy())
    want = np.asarray(jax_segment_reduce_sorted_ref(
        jnp.asarray(vals), jnp.asarray(perm.numpy()), jnp.asarray(jslot),
        accum=accum, num_segments=n))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_exact_segment_sums_match_fsum(kind, dtype):
    """The card's tests measure B3''s error against these sums: within
    eps64 of sum|terms| of ``math.fsum``'s correctly rounded sums."""
    rng, slot, perm, slot_t, nnz = _stream(kind)
    v = rng.standard_normal(slot.size).astype(dtype)
    x = torch.from_numpy(v)[perm.long()]
    got, mag = chip_smoke.exact_segment_sums(x, slot_t, nnz)
    xs = x.double().numpy()
    want = np.array([math.fsum(xs[slot == s]) for s in range(nnz)])
    eps = np.finfo(np.float64).eps
    assert np.all(np.abs(got - want) <= eps * mag)
    assert np.allclose(mag, [np.abs(xs[slot == s]).sum()
                             for s in range(nnz)])


def test_seg_err_over_eps_reads_each_slot_against_its_terms():
    rng, _, perm, slot, nnz = _stream("tile_edge")
    v = torch.from_numpy(rng.standard_normal(slot.shape[0]))
    exact = ss.gather_segment_sum(v, perm, slot, num_segments=nnz)
    assert chip_smoke.seg_err_over_eps(exact, v, perm, slot, 2**-52) <= 16
    off = exact.clone()
    off[7] += 1e-6 * (1 + abs(float(off[7])))
    assert chip_smoke.seg_err_over_eps(off, v, perm, slot, 2**-52) > 1e6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,L", [(0, 1), (5, 2048), (7, 2049),
                                 (10_000, 1_000_000)])
def test_output_and_scratch_share_one_zeroed_allocation(n, L, dtype):
    out, scratch = ss._zeros_and_scratch(n, dtype, L, "cpu")
    words = 1 + -(-L // SEG_TILE) * (2 if dtype == torch.float32 else 4)
    assert out.shape == (n,) and out.dtype == dtype and out.is_contiguous()
    assert scratch.shape == (words,) and scratch.dtype == torch.int64
    assert out.untyped_storage().data_ptr() == \
        scratch.untyped_storage().data_ptr()
    assert n == 0 or out.data_ptr() >= scratch.data_ptr() + 8 * words
    assert not out.any() and not scratch.any()


def test_library_name_follows_the_sources_it_includes(tmp_path,
                                                      monkeypatch):
    """A source that includes another of csrc/ is rebuilt when the
    included one changes (the timing probe includes segment_sum.cu)."""
    monkeypatch.setattr(common, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "a.cu").write_text("int a;\n")
    (tmp_path / "b.cu").write_text('#include "a.cu"\nint b;\n')
    before = common._lib_path("b"), common._lib_path("a")
    (tmp_path / "a.cu").write_text("int a2;\n")
    after = common._lib_path("b"), common._lib_path("a")
    assert before[0] != after[0] and before[1] != after[1]
    assert before[0].name.startswith("libb-")
