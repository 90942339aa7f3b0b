"""B7 (the merge search) on the streams that break a search narrowed by
blocks of queries, on the CPU.

Where the queries are about as many as the targets, the kernel
(``csrc/merge.cu``) narrows each block of queries to the targets between
its least and greatest key and binary-searches splitters of that range
in shared memory before each query finishes its ladder; fewer queries
take one thread a query on the whole ladder.  ``chip_smoke.merge_streams`` builds the streams that test it
(sorted queries with Lq << n and Lq = n, random ones, ties and sentinel
rows at the narrowed ranges' edges, queries below or above every
target, n = 2^k +- 1 and a ragged Lq); the card's tests
(``test_torch_gpu.py``) hold the kernel against the plain version on
them.  Here: the port's wrapper (its plain version) against the JAX
package's ``merge_search_ref``, and the kernel's route in plain PyTorch
(``merge_search_narrowed_ref``) against the plain ladder, bit for bit,
also with small blocks and few splitters, so that every edge of the
narrowing is met at a small size.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.merge.ref import merge_search_ref as jax_merge_search_ref
from repro_torch.kernels.merge import merge as mg
from repro_torch.kernels.merge.ref import (BLOCK_Q, merge_search_narrowed_ref,
                                           merge_search_ref, merge_shape,
                                           pack_keys)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke.py at the repo root
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def _streams(kind, seed=81):
    qr, qc, tr, tc, M = chip_smoke.merge_streams(
        kind, np.random.default_rng(seed), BLOCK_Q)
    return [torch.from_numpy(a) for a in (qr, qc, tr, tc)], M


@pytest.mark.parametrize("kind", chip_smoke.MERGE_KINDS)
def test_merge_streams_keep_the_search_contract(kind):
    """Targets are (col, row)-sorted int32, rows within [0, M]."""
    (qr, qc, tr, tc), M = _streams(kind)
    key = pack_keys(tr, tc)
    assert torch.all(key[1:] >= key[:-1])
    for t in (qr, tr):
        assert t.dtype == torch.int32 and int(t.min()) >= 0 \
            and int(t.max()) <= M


def test_merge_streams_meet_the_edges_they_name():
    (qr, qc, tr, tc), M = _streams("edges")
    key, qkey = pack_keys(tr, tc), pack_keys(qr, qc)
    run = pack_keys(torch.tensor([M]), torch.tensor([7]))
    assert int((key == run).sum()) >= 5000
    blocks = qkey[:qkey.numel() // BLOCK_Q * BLOCK_Q].view(-1, BLOCK_Q)
    assert torch.all(blocks[:, 0] == run) and torch.all(blocks[:, -1] == run)
    assert torch.isin(qkey, key).all()            # every query ties
    (qr, qc, tr, tc), _ = _streams("below")
    assert pack_keys(qr, qc).max() < pack_keys(tr, tc).min()
    (qr, qc, tr, tc), _ = _streams("above")
    assert pack_keys(qr, qc).min() > pack_keys(tr, tc).max()
    (qr, _, _, _), _ = _streams("random")
    assert qr.numel() % BLOCK_Q != 0               # a ragged last block
    # every shape of B7 meets these streams
    want = {"sorted_few": "sparse", "sparse_random": "sparse",
            "n_4095": "ladder", "n_4096": "ladder", "n_4097": "ladder"}
    for kind in chip_smoke.MERGE_KINDS:
        (qr, _, tr, _), _ = _streams(kind)
        assert merge_shape(qr.numel(), tr.numel()) == want.get(kind,
                                                               "dense"), kind
    for n in (1, 4095, 4096, 4097):
        (_, _, tr, _), _ = _streams(f"n_{n}")
        assert tr.numel() == n


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", chip_smoke.MERGE_KINDS)
def test_wrapper_matches_reference_on_merge_streams(kind, side):
    """The port's B7 wrapper (its plain version on the CPU) against the
    JAX package's plain ladder and numpy's searchsorted of the packed
    keys, bit for bit."""
    (qr, qc, tr, tc), _ = _streams(kind)
    got = mg.merge_search_kernel(qr, qc, tr, tc, side=side)
    want = np.asarray(jax_merge_search_ref(
        *(jnp.asarray(t.numpy()) for t in (qr, qc, tr, tc)), side=side))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(
        pack_keys(tr, tc).numpy(), pack_keys(qr, qc).numpy(), side=side))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", chip_smoke.MERGE_KINDS)
def test_narrowed_route_matches_plain_ladder(kind, side):
    """B7's dense route (blocks of 1,024 queries, 256 splitters, the
    ladder to its end) against the plain ladder, bit for bit."""
    (qr, qc, tr, tc), _ = _streams(kind)
    assert torch.equal(merge_search_narrowed_ref(qr, qc, tr, tc, side=side),
                       merge_search_ref(qr, qc, tr, tc, side=side))


@pytest.mark.parametrize("shape", [(16, 4), (32, 2), (7, 33), (1, 256)])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", ["sorted_all", "random", "edges", "n_4097"])
def test_narrowed_route_at_small_shapes(kind, side, shape):
    """Blocks of few queries and few splitters put the narrowed ranges'
    and the splitters' edges on ties and sentinels at a small size."""
    block_q, splitters = shape
    (qr, qc, tr, tc), _ = _streams(kind, seed=5)
    got = merge_search_narrowed_ref(qr, qc, tr, tc, side=side,
                                    block_q=block_q, splitters=splitters)
    assert torch.equal(got, merge_search_ref(qr, qc, tr, tc, side=side))


def test_pack_keys_orders_signed_pairs_lexicographically():
    rng = np.random.default_rng(3)
    ext = np.array([-2**31, -1, 0, 1, 2**31 - 1])
    r = np.concatenate([rng.integers(-2**31, 2**31, 500), ext, ext])
    c = np.concatenate([rng.integers(-3, 3, 500), ext, ext[::-1]])
    key = pack_keys(torch.from_numpy(r.astype(np.int32)),
                    torch.from_numpy(c.astype(np.int32))).numpy()
    np.testing.assert_array_equal(np.argsort(key, kind="stable"),
                                  np.lexsort((r, c)))


@pytest.mark.parametrize("Lq,n,shape", [
    (1, 1, "dense"), (5, 20, "dense"), (4, 17, "ladder"),
    (2**19, 2**23, "ladder"), (2**19 - 1, 2**23, "sparse"),
    (10, 2**23 - 1, "ladder"), (25_000, 2_475_000, "ladder"),
    (5 * 10**5, 49_500_000, "sparse"), (5 * 10**6, 45 * 10**6, "ladder"),
    (6_968_042, 6_968_042, "dense")])
def test_merge_shape_by_queries_and_targets(Lq, n, shape):
    """B7's shape from Lq and n: dense when Lq * 4 >= n, sparse when
    Lq * 16 < n and n >= 2^23 (the 1% update of the 5e7 plan), else the
    ladder (the 10% update, the 2.5e6 sets): the crossings timed over
    n = 2^21 .. 2^25 and n / Lq = 1 .. 128 (kernel_times.py)."""
    assert merge_shape(Lq, n) == shape
