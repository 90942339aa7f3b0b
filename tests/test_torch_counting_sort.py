"""The paper's counting-sort planner (B12 and B11 through their plain
versions on the CPU) and the one-shot ``core`` entry points, against
the JAX package.

Everything here is integer structure, so it agrees bit for bit.  The
reference runs its Pallas kernels in interpret mode; its per-block
histogram pads the bin axis to its tile, so only the first ``nbins``
columns are compared.  The per-block tables depend on the block size,
so both sides are given the same one; the permutation does not.
"""
import functools
import importlib
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.coo import COO as JaxCOO
from repro.core.ransparse import dataset
from repro.kernels.counting_sort.counting_sort import \
    placement as jax_placement
from repro.kernels.counting_sort.ops import counting_sort as jax_counting_sort
from repro.kernels.hist.hist import block_histogram as jax_block_histogram
from repro.kernels.hist.ops import block_offsets as jax_block_offsets
from repro.kernels.hist.ops import histogram as jax_histogram
from repro.sparse.dispatch import sorted_permutation as jax_sorted_permutation
from repro.sparse.pattern import plan as jax_plan
from repro_torch import core
from repro_torch.core.coo import COO
from repro_torch.kernels.counting_sort import counting_sort as cs
from repro_torch.kernels.counting_sort.ops import counting_sort
from repro_torch.kernels.counting_sort.ref import (PLACE_TILE,
                                                   counting_sort_ref,
                                                   placement_ref,
                                                   placement_tiled_ref)
from repro_torch.kernels.hist import hist
from repro_torch.kernels.hist.ops import (block_offsets, default_block_b,
                                          histogram)
from repro_torch.sparse import dispatch
from repro_torch.sparse.pattern import plan

torch.set_num_threads(1)

# the modules, not the functions of the same names that repro.core
# re-exports
jax_assemble = importlib.import_module("repro.core.assemble")
jax_core_fsparse = importlib.import_module("repro.core.fsparse")

FIELDS = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")


def _keys(L, nbins, seed, extra=0):
    """Keys in ``[0, nbins + extra)``: ``extra > 0`` adds out-of-range
    keys, which count nowhere."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, nbins + extra, L).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _table41(k):
    return dataset(k, scale=0.01)


@pytest.mark.parametrize("L,nbins,block_b", [(1, 4, 128), (1000, 51, 128),
                                             (3000, 700, 1024),
                                             (5000, 9, 256)])
def test_block_histogram_matches_reference(L, nbins, block_b):
    keys = _keys(L, nbins, L, extra=3)
    got = hist.block_histogram(torch.from_numpy(keys), nbins=nbins,
                               block_b=block_b)
    want = jax_block_histogram(jnp.asarray(keys), nbins=nbins,
                               block_b=block_b)
    assert got.dtype == torch.int32
    assert got.shape == (-(-L // block_b), nbins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :nbins])
    np.testing.assert_array_equal(
        histogram(torch.from_numpy(keys), nbins=nbins,
                  block_b=block_b).numpy(),
        np.asarray(jax_histogram(jnp.asarray(keys), nbins=nbins,
                                 block_b=block_b)))


@pytest.mark.parametrize("nbins,block_b", [(51, 128), (300, 1024)])
def test_block_offsets_match_reference(nbins, block_b):
    keys = _keys(4000, nbins, nbins)
    offsets, jr = block_offsets(torch.from_numpy(keys), nbins=nbins,
                                block_b=block_b)
    j_off, j_jr = jax_block_offsets(jnp.asarray(keys), nbins=nbins,
                                    block_b=block_b)
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(j_off))
    np.testing.assert_array_equal(jr.numpy(), np.asarray(j_jr))


@pytest.mark.parametrize("L,nbins", [(1, 1), (777, 5), (4000, 51),
                                     (6000, 1200)])
def test_counting_sort_matches_reference(L, nbins):
    keys = _keys(L, nbins, L + nbins)
    rank, pos = counting_sort(torch.from_numpy(keys), nbins=nbins)
    j_rank, j_pos = jax_counting_sort(jnp.asarray(keys), nbins=nbins)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(j_rank))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    for got, want in zip((rank, pos),
                         counting_sort_ref(torch.from_numpy(keys))):
        assert torch.equal(got, want)


def test_placement_does_not_depend_on_the_block_size():
    keys = torch.from_numpy(_keys(9000, 40, 1))
    want = counting_sort_ref(keys)[1]
    for block_b in (1, 33, 1024, 9000, 1 << 16):
        offsets, _ = block_offsets(keys, nbins=40, block_b=block_b)
        assert torch.equal(placement_ref(keys, offsets, nbins=40,
                                         block_b=block_b), want)


def test_out_of_range_keys_are_not_placed():
    keys = torch.tensor([3, -1, 0, 7, 3], dtype=torch.int32)
    offsets, _ = block_offsets(keys, nbins=4, block_b=2)
    assert placement_ref(keys, offsets, nbins=4, block_b=2).tolist() == \
        [1, -1, 0, -1, 2]


# (L, nbins, block_b, tile): a block below, equal to and above a tile,
# tiles that straddle nothing and partial last tiles and blocks
TILED = [(1, 4, 128, 64), (1000, 51, 128, 128), (3000, 700, 512, 100),
         (5000, 9, 256, 1000), (4099, 51, 1024, 256), (2000, 300, 1000, 64)]


@pytest.mark.parametrize("L,nbins,block_b,tile", TILED)
def test_tiled_placement_mirror_matches_reference_and_jax(L, nbins, block_b,
                                                           tile):
    """The kernel's route in plain PyTorch (tile-local ranks, then the
    chained counter handoff) against ``placement_ref`` and the JAX
    ``placement`` in interpret mode, bit for bit."""
    keys = _keys(L, nbins, L + tile)
    offsets, _ = block_offsets(torch.from_numpy(keys), nbins=nbins,
                               block_b=block_b)
    got = placement_tiled_ref(torch.from_numpy(keys), offsets, nbins=nbins,
                              block_b=block_b, tile=tile)
    assert got.dtype == torch.int32
    assert torch.equal(got, placement_ref(torch.from_numpy(keys), offsets,
                                          nbins=nbins, block_b=block_b))
    j_off, _ = jax_block_offsets(jnp.asarray(keys), nbins=nbins,
                                 block_b=block_b)
    want = jax_placement(jnp.asarray(keys), j_off, nbins=nbins,
                         block_b=block_b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("order", ["equal", "sorted", "reversed",
                                   "out_of_range"])
@pytest.mark.parametrize("nbins", [51, 50_001, 1_000_001, (1 << 21) + 3])
def test_tiled_placement_mirror_on_runs_and_wide_keys(order, nbins):
    """All-equal keys (one run a tile), sorted and reversed keys, and
    out-of-range keys (-1), at the kernel's tile and at a small one."""
    rng = np.random.default_rng(nbins)
    L = 20_003
    keys = rng.integers(0, nbins, L).astype(np.int32)
    if order == "equal":
        keys[:] = nbins // 2
    elif order == "sorted":
        keys.sort()
    elif order == "reversed":
        keys = np.sort(keys)[::-1].copy()
    else:
        keys[rng.integers(0, L, 500)] = -3
        keys[rng.integers(0, L, 500)] = nbins + rng.integers(0, 9)
    k = torch.from_numpy(keys)
    for block_b, tile in ((1 << 14, PLACE_TILE), (5000, 1024)):
        offsets, _ = block_offsets(k, nbins=nbins, block_b=block_b)
        want = placement_ref(k, offsets, nbins=nbins, block_b=block_b)
        assert torch.equal(placement_tiled_ref(k, offsets, nbins=nbins,
                                               block_b=block_b, tile=tile),
                           want)
    assert torch.equal(want < 0, (k < 0) | (k >= nbins))


@pytest.mark.parametrize("nbins,block_b", [(1, 1 << 16), (51, 1 << 16),
                                           (50_001, 1 << 16),
                                           (65_537, 1 << 17),
                                           (1_000_001, 1 << 20),
                                           (5_000_000, 1 << 20)])
def test_default_block_size_keeps_the_table_near_one_entry_per_key(
        nbins, block_b):
    assert default_block_b(nbins) == block_b
    L = 10**7
    if nbins <= 1 << 20:
        assert -(-L // block_b) * nbins <= L + block_b


SHAPES = [(1, 1, 1), (50, 7, 5), (3000, 40, 30), (5000, 3, 900)]


@pytest.mark.parametrize("L,M,N", SHAPES)
def test_pallas_permutation_matches_reference_and_fused(L, M, N):
    rng = np.random.default_rng(L)
    rows = rng.integers(0, M + 1, L).astype(np.int32)  # row == M: padding
    cols = rng.integers(0, N, L).astype(np.int32)
    r, c = torch.from_numpy(rows), torch.from_numpy(cols)
    got = dispatch.sorted_permutation(r, c, M=M, N=N, method="pallas")
    assert got.dtype == torch.int32
    want = jax_sorted_permutation(jnp.asarray(rows), jnp.asarray(cols), M=M,
                                  N=N, method="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, dispatch.sorted_permutation(r, c, M=M, N=N,
                                                        method="fused"))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_pallas_plan_fields_match_reference(k):
    ii, jj, _, siz = _table41(k)
    rows, cols = (ii - 1).astype(np.int32), (jj - 1).astype(np.int32)
    before = (hist.block_histogram.launches, cs.placement.launches)
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (siz, siz),
                method="pallas")
    assert (hist.block_histogram.launches, cs.placement.launches) == before
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (siz, siz),
                   method="pallas")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def _coo_pair(L=2000, M=30, N=25, seed=3):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M + 1, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    vals = rng.integers(-9, 10, L).astype(np.float32)
    mine = COO(rows=torch.from_numpy(rows), cols=torch.from_numpy(cols),
               vals=torch.from_numpy(vals), shape=(M, N))
    ref = JaxCOO(rows=jnp.asarray(rows), cols=jnp.asarray(cols),
                 vals=jnp.asarray(vals), shape=(M, N))
    return mine, ref


def _same_csc(A, B):
    for f in ("data", "indices", "indptr", "nnz"):
        np.testing.assert_array_equal(getattr(A, f).numpy(),
                                      np.asarray(getattr(B, f)), err_msg=f)


@pytest.mark.parametrize("nzmax", [None, 700])
@pytest.mark.parametrize("method", ["jnp", "fused", "pallas", "radix"])
def test_core_assemble_every_method_matches_reference(method, nzmax):
    mine, ref = _coo_pair()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # method= is not deprecated
        A = core.assemble(mine, method=method, nzmax=nzmax)
    _same_csc(A, jax_assemble.assemble(ref, method=method, nzmax=nzmax))


@pytest.mark.parametrize("fused,method", [(True, "fused"), (False, "jnp")])
def test_core_fused_flag_warns_and_maps_to_its_method(fused, method):
    mine, ref = _coo_pair(seed=4)
    with pytest.warns(DeprecationWarning) as mine_w:
        A = core.assemble(mine, fused=fused)
    with pytest.warns(DeprecationWarning) as ref_w:
        B = jax_assemble.assemble(ref, fused=fused)
    _same_csc(A, B)
    assert f"method='{method}'" in str(mine_w[0].message)
    assert f"method='{method}'" in str(ref_w[0].message)
    assert mine_w[0].filename == __file__  # points at the caller
    ii, jj = np.array([3, 2, 3]), np.array([1, 2, 1])
    with pytest.warns(DeprecationWarning, match=f"method='{method}'"):
        S = core.fsparse(ii, jj, [7.0, 9.0, 1.0], fused=fused, device="cpu")
    with pytest.warns(DeprecationWarning):
        R = jax_core_fsparse.fsparse(ii, jj, [7.0, 9.0, 1.0], fused=fused)
    _same_csc(S, R)
    with pytest.warns(DeprecationWarning):
        C = core.fsparse_coo(mine, fused=fused)
    _same_csc(C, jax_core_fsparse.fsparse_coo(ref, method=method))


def test_core_default_method_follows_the_device():
    assert core.resolve_method_arg(None, None, api="x", device="cpu") \
        == "fused"
    assert core.resolve_method_arg(None, None, api="x") == "radix"
    assert core.resolve_method_arg(None, "pallas", api="x") == "pallas"


def test_parts_and_intermediates_match_reference():
    ii, jj, ss_, siz = _table41(1)
    rows, cols = (ii - 1).astype(np.int32), (jj - 1).astype(np.int32)
    r, c = torch.from_numpy(rows), torch.from_numpy(cols)
    jr_, jc_ = jnp.asarray(rows), jnp.asarray(cols)
    jrS = core.part1_count_rows(r, siz)
    np.testing.assert_array_equal(
        jrS.numpy(), np.asarray(jax_assemble.part1_count_rows(jr_, siz)))
    np.testing.assert_array_equal(
        core.counting_sort_positions(r, jrS).numpy(),
        np.asarray(jax_assemble.counting_sort_positions(
            jr_, jnp.asarray(jrS.numpy()))))
    rank = core.part2_rank(r, siz)
    j_rank = jax_assemble.part2_rank(jr_, siz)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(j_rank))
    mine = core.part3_unique(r, c, rank, siz, siz)
    ref = jax_assemble.part3_unique(jr_, jc_, j_rank, siz, siz)
    for got, want in zip(mine, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fin = core.part4_finalize(mine[1], mine[2])
    j_fin = jax_assemble.part4_finalize(ref[1], ref[2])
    for got, want in zip(fin, j_fin):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = np.random.default_rng(1).integers(-4, 5, rows.shape[0]).astype(
        np.float32)
    perm, first, _, r_s, _, valid = mine
    nnz = int(fin[2])
    for nzmax in (rows.shape[0], nnz // 2):
        got = core.postprocess(torch.from_numpy(vals), r_s, fin[1], first,
                               valid, perm, nzmax, siz)
        want = jax_assemble.postprocess(jnp.asarray(vals), ref[3], j_fin[1],
                                        ref[1], ref[5], ref[0], nzmax, siz)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    inter = core.assembly_intermediates(r, c, M=siz, N=siz)
    j_inter = jax_assemble.assembly_intermediates(jr_, jc_, M=siz, N=siz)
    for f in core.AssemblyIntermediate._fields:
        np.testing.assert_array_equal(getattr(inter, f).numpy(),
                                      np.asarray(getattr(j_inter, f)),
                                      err_msg=f)


def test_cpu_counting_sort_never_launches():
    before = (hist.block_histogram.launches, cs.placement.launches)
    counting_sort(torch.from_numpy(_keys(500, 9, 2)), nbins=9)
    assert (hist.block_histogram.launches, cs.placement.launches) == before
    rank, pos = counting_sort(torch.zeros(0, dtype=torch.int32), nbins=3)
    assert rank.shape == pos.shape == (0,)
