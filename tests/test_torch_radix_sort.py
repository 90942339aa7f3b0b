"""The port's radix planner against the JAX reference.

On the CPU the B1/B2 wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode.  Everything here is
integer, so every comparison is bit-identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.radix_sort.ops import \
    radix_pass_positions as jax_radix_pass_positions
from repro.kernels.radix_sort.ops import radix_sort_pair as jax_radix_sort_pair
from repro.kernels.radix_sort.radix_sort import \
    digit_block_histogram as jax_digit_block_histogram
from repro.kernels.radix_sort.ref import digit_rank_ref as jax_digit_rank_ref
from repro_torch.kernels.radix_sort import ops, radix_sort as rs, ref

torch.set_num_threads(1)

# shapes of the reference's own radix tests (tests/test_kernels.py)
PASS_CASES = [(1000, 5000, 0, 7), (1000, 5000, 7, 6), (257, 255, 0, 8)]
PAIR_CASES = [(100, 8, 8, 64), (3000, 700, 900, 512), (17, 3, 3, 8),
              (2048, 46341, 46341, 256)]


def _keys(L, vmax, seed):
    return np.random.default_rng(seed).integers(0, vmax + 1, L) \
        .astype(np.int32)


def _nbins(vmax, shift, bits):
    top = shift + bits >= vmax.bit_length()
    return (vmax >> shift) + 1 if top else 1 << bits


def _pair(L, M, N):
    rng = np.random.default_rng(L + M)
    rows = rng.integers(0, M + 1, L).astype(np.int32)  # + padding sentinel
    cols = rng.integers(0, N, L).astype(np.int32)
    return rows, cols


@pytest.mark.parametrize("tile", [256, rs.TILE])
@pytest.mark.parametrize("L,vmax,shift,bits", PASS_CASES)
def test_digit_histogram_matches_reference(L, vmax, shift, bits, tile):
    keys = _keys(L, vmax, L + shift)
    nbins = _nbins(vmax, shift, bits)
    want = np.asarray(jax_digit_block_histogram(
        jnp.asarray(keys), shift=shift, bits=bits, nbins=nbins,
        block_b=tile))[:, :nbins]
    got = ref.digit_block_histogram_ref(torch.from_numpy(keys), shift=shift,
                                        bits=bits, nbins=nbins, tile=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().T, want)  # digit-major


@pytest.mark.parametrize("L,vmax,shift,bits", PASS_CASES)
def test_radix_pass_positions_match_reference(L, vmax, shift, bits):
    keys = _keys(L, vmax, L + shift)
    nbins = _nbins(vmax, shift, bits)
    want = jax_radix_pass_positions(jnp.asarray(keys), shift=shift,
                                    bits=bits, nbins=nbins, block_b=256)
    got = ops.radix_pass_positions(torch.from_numpy(keys), shift=shift,
                                   bits=bits, nbins=nbins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L,vmax,shift,bits", PASS_CASES)
def test_placement_is_stable_digit_sort(L, vmax, shift, bits):
    """B2 with the scanned B1 histogram as base = stable argsort of the
    digit; a payload is carried through the same permutation."""
    keys = torch.from_numpy(_keys(L, vmax, L + shift))
    kw = dict(shift=shift, bits=bits, nbins=_nbins(vmax, shift, bits))
    base = ops.digit_bases(rs.digit_block_histogram(keys, **kw))
    rank = rs.digit_placement(keys, base, None, **kw)
    want = jax_digit_rank_ref(jnp.asarray(keys.numpy()), shift=shift,
                              bits=bits)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        rank.numpy(), ref.digit_rank_ref(keys, shift=shift, bits=bits))
    payload = torch.from_numpy(
        np.random.default_rng(1).permutation(L).astype(np.int32))
    moved = rs.digit_placement(keys, base, payload, **kw)
    np.testing.assert_array_equal(moved.numpy(), payload[rank].numpy())


@pytest.mark.parametrize("max_bits", [None, 3])
@pytest.mark.parametrize("L,M,N,block_b", PAIR_CASES)
def test_radix_sort_pair_matches_reference(L, M, N, block_b, max_bits):
    rows, cols = _pair(L, M, N)
    want = jax_radix_sort_pair(jnp.asarray(rows), jnp.asarray(cols), M=M,
                               N=N, block_b=block_b)
    got = ops.radix_sort_pair(torch.from_numpy(rows), torch.from_numpy(cols),
                              M=M, N=N, max_bits=max_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), ref.radix_sort_pair_ref(torch.from_numpy(rows),
                                             torch.from_numpy(cols), M=M,
                                             N=N).numpy())


def test_radix_sort_is_stable():
    rows = torch.tensor([2, 1, 2, 1, 2, 0, 0], dtype=torch.int32)
    cols = torch.zeros(7, dtype=torch.int32)
    perm = ops.radix_sort_pair(rows, cols, M=3, N=1)
    # equal (col,row) keys keep original input order
    assert perm.tolist() == [5, 6, 1, 3, 0, 2, 4]


def test_digit_plan_covers_words_and_bounds_bins():
    """The port's own priors: every bit of both words covered by
    contiguous digits of at most 8 bits."""
    for (M, N, L) in [(1, 1, 1), (7, 13, 100), (5000, 5000, 250_000),
                      (46341, 46341, 4096), (10**9, 10**9, 10**6)]:
        passes = ops.plan_digit_passes(M, N, L)
        for vmax, src_col in ((M, False), (N, True)):
            word = [p for p in passes if p.src_col == src_col]
            assert sum(p.bits for p in word) == max(1, vmax.bit_length())
            assert word[0].shift == 0
            for a, b in zip(word, word[1:]):
                assert b.shift == a.shift + a.bits  # contiguous digits
            for p in word:
                assert p.nbins <= 1 << p.bits <= 1 << rs.KERNEL_MAX_BITS


@pytest.mark.parametrize("siz,L,npass", [
    (10_000, 2_500_000, 4), (50_000, 2_500_000, 4), (1_000_000, 50 * 10**6, 6),
])
def test_digit_plan_takes_fewest_passes(siz, L, npass):
    """Table 4.1 sizes: 4 passes (8 launches); siz = 10^6: 6 passes."""
    assert len(ops.plan_digit_passes(siz, siz, L)) == npass


@pytest.mark.parametrize("max_bits", [0, rs.KERNEL_MAX_BITS + 1])
def test_digit_plan_rejects_widths_the_kernels_cannot_take(max_bits):
    with pytest.raises(ValueError, match="max_bits"):
        ops.plan_digit_passes(10, 10, 10, max_bits=max_bits)


def test_cpu_tensors_never_launch():
    before = (rs.digit_block_histogram.launches, rs.digit_placement.launches)
    rows, cols = _pair(100, 8, 8)
    ops.radix_sort_pair(torch.from_numpy(rows), torch.from_numpy(cols),
                        M=8, N=8)
    assert (rs.digit_block_histogram.launches,
            rs.digit_placement.launches) == before


def _stable_placement(keys, payload, carry, shift, bits, nbins):
    """numpy: the placed words of one stable pass, digits >= nbins left
    out."""
    d = (keys >> shift) & ((1 << bits) - 1)
    order = np.argsort(np.where(d < nbins, d, 1 << 30), kind="stable")
    order = order[:int((d < nbins).sum())]
    return [w[order] for w in (payload, *carry)]


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("L,tile", [(1, rs.TILE), (1000, rs.TILE),
                                    (3 * 256 + 17, 256),
                                    (2 * rs.TILE + 5, rs.TILE)])
@pytest.mark.parametrize("bits", range(1, 9))
def test_placement_carries_words_in_stable_order(bits, L, tile, full):
    """B2's plain version with two carried words (the keys among them)
    against a numpy stable argsort: every digit width, a ragged tile,
    L below one tile, and digits >= nbins (never placed)."""
    rng = np.random.default_rng(bits * 1000 + L)
    shift = 3
    keys = rng.integers(0, 1 << 20, L).astype(np.int32)
    nbins = 1 << bits if full else max(1, (1 << bits) - 2)
    payload = rng.permutation(L).astype(np.int32)
    other = rng.integers(-5, 5, L).astype(np.int32)
    kw = dict(shift=shift, bits=bits, nbins=nbins, tile=tile)
    tk = torch.from_numpy(keys)
    base = ops.digit_bases(ref.digit_block_histogram_ref(tk, **kw))
    out, carried = ref.digit_placement_ref(
        tk, base, torch.from_numpy(payload),
        carry=(tk, torch.from_numpy(other)), **kw)
    want = _stable_placement(keys, payload, (keys, other), shift, bits,
                             nbins)
    n = want[0].shape[0]
    for got, w in zip((out, *carried), want):
        assert got.dtype == torch.int32 and got.shape == (L,)
        np.testing.assert_array_equal(got[:n].numpy(), w)
    # without a payload the placed word is the input position
    rank = ref.digit_placement_ref(tk, base, None, **kw)
    np.testing.assert_array_equal(
        rank[:n].numpy(), _stable_placement(keys, np.arange(L, dtype=np.int32),
                                            (), shift, bits, nbins)[0])


def test_placement_wrapper_returns_carried_words_on_cpu():
    keys = torch.from_numpy(_keys(5000, 5000, 9))
    kw = dict(shift=0, bits=7, nbins=128)
    base = ops.digit_bases(rs.digit_block_histogram(keys, **kw))
    plain = rs.digit_placement(keys, base, None, **kw)
    out, (moved,) = rs.digit_placement(keys, base, None, carry=(keys,), **kw)
    assert torch.equal(out, plain)
    assert torch.equal(moved, keys[plain])


@pytest.mark.parametrize("L,M,N", [
    (5000, 200, 100),        # one pass a word
    (5000, 70_000, 3),       # three row passes, one column pass
    (5000, 3, 70_000),       # one row pass, three column passes
    (4099, 1 << 20, 1 << 20),  # three and three (the 5e7 set's plan)
])
def test_carried_radix_sort_pair_matches_reference_and_stable_sort(L, M, N):
    rows, cols = _pair(L, M, N)
    got = ops.radix_sort_pair(torch.from_numpy(rows), torch.from_numpy(cols),
                              M=M, N=N)
    want = jax_radix_sort_pair(jnp.asarray(rows), jnp.asarray(cols), M=M,
                               N=N, block_b=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.lexsort((rows, cols)).astype(np.int32))


@pytest.mark.parametrize("M,N,want", [
    (200, 100, [(False, True), (False, False)]),
    (70_000, 3, [(True, True), (True, True), (False, True),
                 (False, False)]),
    (3, 70_000, [(False, True), (False, True), (False, True),
                 (False, False)]),
])
def test_each_pass_carries_the_words_later_passes_read(M, N, want):
    passes = ops.plan_digit_passes(M, N, 5000)
    assert [ops.carried_words(passes, i)
            for i in range(len(passes))] == want
