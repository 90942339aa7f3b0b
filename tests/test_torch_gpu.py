"""The port's CUDA kernels and main path on the card.

Every test here is marked ``gpu`` and skips, inside the test, when
``torch.cuda.is_available()`` is false.  The file imports nothing of
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same
inputs: the integer kernels (B1, B2, B11, B12) and the min/max fill
(B4) bit for bit, the fill (B3') bit for bit on integer-valued data and
within ``8 * eps * max_s sum|v|`` on random values (the plain version's
``index_add_`` adds in another order on the card); on runs that cross
its tiles, within ``16 * eps`` of each slot's sum|terms| of the exact
sum (``chip_smoke.exact_segment_sums``) and bit for bit from call to
call; the prefix sum (B5)
bit for bit on integer-valued data and within ``64 * eps`` of the
running sum of ``|x|`` on random values, zero-mean and same-sign (the
kernel's first-order worst case is about 31 eps; see
``csrc/segment_sum.cu``).  B11 is also held
against the plain mirror of its tiled route
(``placement_tiled_ref``).  The LM serving path's tests (at the end)
hold the counting sort at MoE shapes against ``torch.argsort``, the MoE
dispatch, a reduced OLMoE's prefill and decode (float32, within 1e-4 of
``max|logit|``) and the embedding gradient on the card against the CPU;
the training path's, a reduced OLMoE's train step (loss and
``grad_norm`` within 1e-4 of the CPU's, B12 and B11 launched
``microbatches x (2 L + 1)`` times a step) and a checkpoint of its
state saved and restored on the card bit for bit; the ssm and hybrid
families', the chunked SSD scan and a reduced Mamba2's and Zamba2's
forward and ``loss_fn`` gradients (float32) against the CPU; the encdec
and vlm families', a reduced Seamless's and Llama-3.2-Vision's forward,
decode and gradients against the CPU, and the embedding gradient at
their vocabularies (128,256 and 256,256 bins, B12's global counters).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.coo import coo_from_matlab
from repro_torch.core.oracle import matlab_sparse_oracle
from repro_torch.core.ransparse import dataset
from repro_torch.kernels.counting_sort import counting_sort as cs
from repro_torch.kernels.counting_sort.ops import counting_sort
from repro_torch.kernels.counting_sort.ref import (PLACE_TILE,
                                                   placement_ref,
                                                   placement_tiled_ref)
from repro_torch.kernels.hist import hist
from repro_torch.kernels.hist.ops import block_offsets, default_block_b
from repro_torch.kernels.hist.ref import block_histogram_ref
from repro_torch.kernels.radix_sort import ops, radix_sort as rs, ref
from repro_torch.kernels.segment_sum import segment_sum as ss
from repro_torch.kernels.segment_sum.ref import (SCAN_TILE, SEG_TILE,
                                                 blocked_cumsum_ref,
                                                 gather_segment_minmax_ref,
                                                 gather_segment_sum_ref)
from repro_torch.sparse import matlab, tuning
from repro_torch.sparse.pattern import plan

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return torch.device("cuda")


def _launches():
    return (rs.digit_block_histogram.launches, rs.digit_placement.launches,
            ss.gather_segment_sum.launches)


@pytest.mark.parametrize("L", [1, 31, rs.TILE - 1, rs.TILE + 1, 100_003])
def test_radix_kernels_match_plain_versions(L):
    dev = _cuda()
    rng = np.random.default_rng(L)
    keys = torch.from_numpy(rng.integers(0, 50_001, L).astype(np.int32)) \
        .to(dev)
    payload = torch.from_numpy(rng.permutation(L).astype(np.int32)).to(dev)
    for shift, bits, nbins in ((0, 8, 256), (8, 8, 196), (12, 4, 13)):
        kw = dict(shift=shift, bits=bits, nbins=nbins)
        h = rs.digit_block_histogram(keys, **kw)
        assert torch.equal(h, ref.digit_block_histogram_ref(
            keys, tile=rs.TILE, **kw))
        base = ops.digit_bases(h)
        for p in (None, payload):
            assert torch.equal(
                rs.digit_placement(keys, base, p, **kw),
                ref.digit_placement_ref(keys, base, p, tile=rs.TILE, **kw))


# B1 on chip_smoke.hist_stream's skewed streams (every key equal, one
# digit, sorted, reversed, runs of 32 across loads and tiles, digits >=
# nbins) and on a view 4 bytes into its storage (scalar loads)
@pytest.mark.parametrize("L", [1, rs.TILE - 1, rs.TILE + 1,
                               2 * rs.TILE - 1, 2 * rs.TILE + 1, 2_500_000])
@pytest.mark.parametrize("kind", ["equal", "one_digit", "sorted",
                                  "reversed", "runs32", "over_nbins",
                                  "unaligned"])
def test_digit_histogram_on_skewed_streams(kind, L):
    """Bit for bit the plain version's, the same bits from two launches,
    one launch a call."""
    dev = _cuda()
    keys, kw = _smoke().hist_stream(
        "over_nbins" if kind == "unaligned" else kind, L,
        np.random.default_rng(L))
    keys = torch.from_numpy(keys).to(dev)
    if kind == "unaligned":
        keys = _unaligned(keys)
    before = rs.digit_block_histogram.launches
    a = rs.digit_block_histogram(keys, **kw)
    b = rs.digit_block_histogram(keys, **kw)
    assert rs.digit_block_histogram.launches == before + 2
    assert torch.equal(a, ref.digit_block_histogram_ref(keys, tile=rs.TILE,
                                                        **kw))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["runs32", "over_nbins"])
def test_digit_histogram_over_several_chunks(kind):
    """A stream long enough that each block walks more than two staged
    chunks of tiles, with a ragged last tile: bit for bit the plain
    version's."""
    dev = _cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    L = (2 * tuning.prior_value("radix_sort", "hist_chunk") + 3) \
        * sms * rs.HIST_PER_SM * rs.TILE - 5
    keys, kw = _smoke().hist_stream(kind, L, np.random.default_rng(9))
    keys = torch.from_numpy(keys).to(dev)
    assert ref.hist_runs(-(-L // rs.TILE), sms, rs.HIST_PER_SM)[0] > \
        2 * tuning.prior_value("radix_sort", "hist_chunk")
    assert torch.equal(rs.digit_block_histogram(keys, **kw),
                       ref.digit_block_histogram_ref(keys, tile=rs.TILE,
                                                     **kw))


@pytest.mark.parametrize("variant", ["replaced", "shipped", "private",
                                     "match", "private_match",
                                     "block_parity", "chunk8", "chunk32"])
def test_digit_histogram_probe_variants_match_plain_version(variant):
    """Each of B1's timing variants (csrc/radix_sort_probe.cu), at its own
    run length and at 1 and 37 tiles a block, bit for bit the plain
    version's on a ragged stream of random keys and of runs of 32."""
    dev = _cuda()
    smoke = _smoke()
    for kind in ("over_nbins", "runs32"):
        keys, kw = smoke.hist_stream(kind, 41 * rs.TILE + 7,
                                     np.random.default_rng(11))
        keys = torch.from_numpy(keys).to(dev)
        want = ref.digit_block_histogram_ref(keys, tile=rs.TILE, **kw)
        for run in (0, 1, 37):
            assert torch.equal(smoke.hist_probe(
                smoke.HIST_VARIANTS[variant], keys, kw, run=run), want)


def test_radix_sort_pair_counts_one_launch_per_kernel_and_pass():
    dev = _cuda()
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.integers(0, 701, 3000).astype(np.int32)).to(dev)
    c = torch.from_numpy(rng.integers(0, 900, 3000).astype(np.int32)).to(dev)
    before = _launches()
    perm = ops.radix_sort_pair(r, c, M=700, N=900)
    npass = len(ops.plan_digit_passes(700, 900, 3000))
    assert _launches() == (before[0] + npass, before[1] + npass, before[2])
    assert torch.equal(perm, ref.radix_sort_pair_ref(r, c, M=700, N=900))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_fill_kernel_matches_plain_version(dtype, frac):
    dev = _cuda()
    rng = np.random.default_rng(11)
    rows = torch.from_numpy(rng.integers(0, 301, 20000).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 300, 20000).astype(np.int32))
    pat = plan(rows.to(dev), cols.to(dev), (300, 300))
    nzmax = int(frac * int(pat.nnz))
    args = (pat.perm, pat.slot)
    vi = torch.from_numpy(rng.integers(-8, 9, 20000)).to(dev, dtype)
    before = _launches()
    got = ss.gather_segment_sum(vi, *args, num_segments=nzmax)
    assert _launches()[2] == before[2] + 1
    assert torch.equal(got, gather_segment_sum_ref(vi, *args,
                                                   num_segments=nzmax))
    vn = torch.from_numpy(rng.standard_normal(20000)).to(dev, dtype)
    mag = gather_segment_sum_ref(vn.abs(), *args, num_segments=nzmax)
    err = (ss.gather_segment_sum(vn, *args, num_segments=nzmax)
           - gather_segment_sum_ref(vn, *args, num_segments=nzmax)).abs()
    assert bool(torch.all(err <= 8 * torch.finfo(dtype).eps * mag.max()))


def test_cuda_tensors_never_fall_back():
    dev = _cuda()
    v = torch.ones(4, dtype=torch.complex64, device=dev)
    i = torch.arange(4, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="complex"):
        ss.gather_segment_sum(v, i, i, num_segments=4)
    with pytest.raises(TypeError):
        rs.digit_block_histogram(i.long(), shift=0, bits=2, nbins=4)
    # a short value vector would be read past its end: refused
    for kern, kw in ((ss.gather_segment_sum, {}),
                     (ss.gather_segment_minmax, {"op": "max"})):
        with pytest.raises(ValueError, match="one value per stream"):
            kern(v.real[:3].contiguous(), i, i, num_segments=4, **kw)


@pytest.mark.parametrize("accum", ["sum", "mean", "max"])
def test_gradient_of_fill_fused_on_card_matches_cpu(accum):
    from repro_torch.kernels import assembly_ops

    dev = _cuda()
    rng = np.random.default_rng(23)
    rows = torch.from_numpy(rng.integers(0, 13, 300).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 9, 300).astype(np.int32))
    v = torch.from_numpy(rng.integers(-3, 4, 300).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    grads = []
    for d in ("cpu", dev):
        pat = plan(rows.to(d), cols.to(d), (12, 9))
        x = v.to(d).requires_grad_()
        out = assembly_ops.fill_fused(pat, x, accum=accum).data
        (g,) = torch.autograd.grad((out * w.to(d)).sum(), x)
        grads.append(g.cpu())
    assert torch.equal(grads[0], grads[1])
    assert bool(grads[0].abs().sum() > 0)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fsparse_matches_oracle_through_the_kernels(k):
    _cuda()
    ii, jj, ss_, siz = dataset(k, scale=0.01)
    before = _launches()
    S = matlab.fsparse(ii, jj, ss_, (siz, siz))
    assert S.data.is_cuda
    npass = len(ops.plan_digit_passes(siz, siz, ii.shape[0]))
    assert _launches() == (before[0] + npass, before[1] + npass,
                           before[2] + 1)
    pr, ir, jc = matlab_sparse_oracle(ii - 1, jj - 1, ss_, siz, siz)
    nnz = int(S.nnz)
    np.testing.assert_array_equal(S.indptr.cpu().numpy(), jc)
    np.testing.assert_array_equal(S.indices[:nnz].cpu().numpy(), ir)
    np.testing.assert_array_equal(S.data[:nnz].cpu().numpy(),
                                  pr.astype(np.float32))


def test_gradient_of_fill_on_card_matches_cpu():
    dev = _cuda()
    rng = np.random.default_rng(21)
    rows = torch.from_numpy(rng.integers(0, 13, 200).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 9, 200).astype(np.int32))
    v = torch.from_numpy(rng.standard_normal(200).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(200).astype(np.float32))
    grads = []
    for d in ("cpu", dev):
        pat = plan(rows.to(d), cols.to(d), (12, 9))
        x = v.to(d).requires_grad_()
        (g,) = torch.autograd.grad((pat.assemble(x).data * w.to(d)).sum(), x)
        grads.append(g.cpu())
    assert torch.equal(grads[0], grads[1])


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("frac", [None, 0.5])
def test_minmax_kernel_matches_plain_version(dtype, op, frac):
    dev = _cuda()
    rng = np.random.default_rng(12)
    rows = torch.from_numpy(rng.integers(0, 301, 20000).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 300, 20000).astype(np.int32))
    pat = plan(rows.to(dev), cols.to(dev), (300, 300), nzmax_slack=5000)
    # None: the plan's capacity, with empty slots in the tail; 0.5: a
    # capacity below nnz.  A count above the plan's nzmax (once 1.3 x
    # nnz here) is outside the kernels' contract: it keeps the padding
    # sentinel, whose runs are not adjacent, and there the card differed
    # from the plain version (gather_segment_minmax's docstring).
    nzmax = pat.nzmax if frac is None else int(frac * int(pat.nnz))
    v = torch.from_numpy(rng.standard_normal(20000)).to(dev, dtype)
    v[[5, 77]] = float("nan")
    before = ss.gather_segment_minmax.launches
    got = ss.gather_segment_minmax(v, pat.perm, pat.slot,
                                   num_segments=nzmax, op=op)
    assert ss.gather_segment_minmax.launches == before + 1
    assert bool(torch.isnan(got).any())
    assert _same(got, gather_segment_minmax_ref(v, pat.perm, pat.slot,
                                                num_segments=nzmax, op=op))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 4095, 4097, 100_003, 5_000_000])
def test_prefix_sum_kernel_matches_plain_version(dtype, L):
    dev = _cuda()
    rng = np.random.default_rng(L)
    xi = torch.from_numpy(rng.integers(-8, 9, L)).to(dev, dtype)
    before = ss.blocked_cumsum.launches
    assert torch.equal(ss.blocked_cumsum(xi), blocked_cumsum_ref(xi))
    assert ss.blocked_cumsum.launches == before + 1
    xn = torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
    err = (ss.blocked_cumsum(xn) - blocked_cumsum_ref(xn)).abs()
    tol = 64 * torch.finfo(dtype).eps * torch.cumsum(xn.abs(), 0)
    assert bool(torch.all(err <= tol))


@pytest.mark.parametrize("nbins,block_b", [(51, 1024), (50_001, 1 << 16),
                                           (1_000_001, 1 << 20),
                                           (1_000_001, 4096)])
def test_counting_sort_kernels_match_plain_versions(nbins, block_b):
    """B12 and B11 at Table 4.1's and the 5e7 set's widths, and with
    the 10^6 + 1 bins cut in blocks of one tile."""
    dev = _cuda()
    rng = np.random.default_rng(nbins)
    L = 300_007
    keys = torch.from_numpy(rng.integers(0, nbins, L).astype(np.int32)) \
        .to(dev)
    before = (hist.block_histogram.launches, cs.placement.launches)
    h = hist.block_histogram(keys, nbins=nbins, block_b=block_b)
    assert torch.equal(h, block_histogram_ref(keys, nbins=nbins,
                                              block_b=block_b))
    offsets, _ = block_offsets(keys, nbins=nbins, block_b=block_b)
    copy = offsets.clone()
    pos = cs.placement(keys, offsets, nbins=nbins, block_b=block_b)
    assert torch.equal(offsets, copy)  # the kernel's counters are its own
    assert torch.equal(pos, placement_ref(keys, offsets, nbins=nbins,
                                          block_b=block_b))
    assert (hist.block_histogram.launches, cs.placement.launches) == (
        before[0] + 2, before[1] + 1)
    rank, cpos = counting_sort(keys, nbins=nbins, block_b=block_b)
    assert torch.equal(rank.long(), torch.sort(keys, stable=True).indices)
    assert torch.equal(cpos, pos)  # the sort hands its table over
    handed = offsets.clone()
    assert torch.equal(cs.placement(keys, handed, nbins=nbins,
                                    block_b=block_b, consume_offsets=True),
                       pos)


def _placement_case(keys, nbins, block_b):
    """B11 on ``keys`` against its plain version (and the tiled mirror),
    one launch, the caller's table untouched."""
    offsets, _ = block_offsets(keys, nbins=nbins, block_b=block_b)
    copy = offsets.clone()
    before = cs.placement.launches
    pos = cs.placement(keys, offsets, nbins=nbins, block_b=block_b)
    assert cs.placement.launches == before + 1
    assert torch.equal(offsets, copy)
    want = placement_ref(keys, offsets, nbins=nbins, block_b=block_b)
    assert torch.equal(pos, want)
    assert torch.equal(placement_tiled_ref(keys, offsets, nbins=nbins,
                                           block_b=block_b), want)
    return pos


@pytest.mark.parametrize("L,block_b", [
    (1, 1024), (4095, 1024), (10_001, 1024),           # block below a tile
    (PLACE_TILE, PLACE_TILE), (3 * PLACE_TILE + 7, PLACE_TILE),  # equal
    (PLACE_TILE - 1, 5000), (20_003, 5000),            # partial tiles
    (50_003, PLACE_TILE + 5000),                       # and blocks
    (300_007, 1 << 16), (2_000_001, 1 << 20)])         # many tiles a block
def test_placement_tiles_at_every_straddle(L, block_b):
    dev = _cuda()
    rng = np.random.default_rng(L + block_b)
    keys = torch.from_numpy(rng.integers(0, 777, L).astype(np.int32)).to(dev)
    _placement_case(keys, 777, block_b)


@pytest.mark.parametrize("order", ["equal", "sorted", "reversed"])
@pytest.mark.parametrize("block_b", [1024, 1 << 16])
def test_placement_on_runs_sorted_and_reversed_keys(order, block_b):
    """One run a tile (the longest chain of handoffs), and keys whose
    tiles hold one run each or many."""
    dev = _cuda()
    L, nbins = 200_003, 50_001
    if order == "equal":
        keys = torch.full((L,), 17, dtype=torch.int32, device=dev)
    else:
        keys = torch.sort(torch.from_numpy(np.random.default_rng(1).integers(
            0, nbins, L).astype(np.int32)).to(dev)).values
        if order == "reversed":
            keys = keys.flip(0).contiguous()
    pos = _placement_case(keys, nbins, block_b)
    if order != "reversed":  # already stably sorted: the identity
        assert torch.equal(pos, torch.arange(L, dtype=torch.int32,
                                             device=dev))


@pytest.mark.parametrize("nbins", [51, 50_001, 1_000_001, (1 << 21) + 3])
def test_placement_with_out_of_range_keys_at_every_width(nbins):
    """Out-of-range keys (below 0 and at or past nbins) get -1; 2^21 + 3
    bins sort over 22 key bits (three 8-bit passes)."""
    dev = _cuda()
    rng = np.random.default_rng(nbins)
    L = 400_009
    keys = rng.integers(-3, nbins + 3, L).astype(np.int32)
    keys[rng.integers(0, L, 50)] = np.iinfo(np.int32).max
    keys = torch.from_numpy(keys).to(dev)
    block_b = default_block_b(nbins)
    pos = _placement_case(keys, nbins, block_b)
    inside = (keys >= 0) & (keys < nbins)
    assert bool(torch.all((pos == -1) == ~inside))


@pytest.mark.parametrize("L,nbins", [(5_000_000, 1_000_001),
                                     (2_500_000, 50_001),
                                     (50_000_000, 1_000_001)])
def test_placement_and_prefix_sum_repeat_bit_for_bit(L, nbins):
    """20 calls back to back, each bit-identical to the first: a stale
    ticket or flag, or counters read before they were published, would
    show as a difference.  Tables of 20 MB and 7.8 MB (Table 4.1's width)
    sit in the L2; the 5e7 set's 192 MB does not."""
    dev = _cuda()
    rng = np.random.default_rng(20)
    keys = torch.from_numpy(rng.integers(0, nbins, L).astype(np.int32)) \
        .to(dev)
    block_b = default_block_b(nbins)
    offsets, _ = block_offsets(keys, nbins=nbins, block_b=block_b)
    want = placement_ref(keys, offsets, nbins=nbins, block_b=block_b)
    xs = [torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
          for dtype in (torch.float32, torch.float64)]
    firsts = [ss.blocked_cumsum(x) for x in xs]
    for _ in range(20):
        assert torch.equal(cs.placement(keys, offsets, nbins=nbins,
                                        block_b=block_b), want)
        handed = offsets.clone()
        assert torch.equal(cs.placement(keys, handed, nbins=nbins,
                                        block_b=block_b,
                                        consume_offsets=True), want)
        for x, first in zip(xs, firsts):
            assert torch.equal(ss.blocked_cumsum(x), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [5_000_000, 50_000_000])
def test_prefix_sum_on_same_sign_data(dtype, L):
    """Uniform values in [0, 1): no cancellation, so an error that grows
    with the number of chained tile prefixes would reach the tolerance;
    within 64 eps of the running sum against the plain version, and in
    float32 also against a float64 prefix sum."""
    dev = _cuda()
    rng = np.random.default_rng(L + 1)
    x = torch.from_numpy(rng.random(L)).to(dev, dtype)
    got = ss.blocked_cumsum(x)
    run = torch.cumsum(x.double(), 0)  # x >= 0: the running sum of |x|
    tol = 64 * torch.finfo(dtype).eps * run
    err = (got - blocked_cumsum_ref(x)).double().abs()
    assert bool(torch.all(err <= tol))
    if dtype == torch.float32:
        assert bool(torch.all((got.double() - run).abs() <= tol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", ["below", "at", "above"])
def test_prefix_sum_at_the_tile_edges(dtype, where):
    dev = _cuda()
    T = SCAN_TILE
    L = {"below": T - 1, "at": T, "above": T + 1}[where]
    rng = np.random.default_rng(L)
    xi = torch.from_numpy(rng.integers(-8, 9, L)).to(dev, dtype)
    assert torch.equal(ss.blocked_cumsum(xi), blocked_cumsum_ref(xi))
    xn = torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
    err = (ss.blocked_cumsum(xn) - blocked_cumsum_ref(xn)).abs()
    tol = 64 * torch.finfo(dtype).eps * torch.cumsum(xn.abs(), 0)
    assert bool(torch.all(err <= tol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [5_000_000, 50_000_000])
def test_prefix_sum_on_cancelling_and_unaligned_data(dtype, L):
    """A running sum that cancels (+a, -a pairs: every even prefix is
    0), integer-valued data at 5e7 (exact), and a view that starts 4
    bytes in (no 16-byte vectors)."""
    dev = _cuda()
    rng = np.random.default_rng(L)
    a = torch.from_numpy(rng.standard_normal(L // 2)).to(dev, dtype)
    x = torch.stack([a, -a], 1).reshape(-1)
    got = ss.blocked_cumsum(x)
    err = (got - blocked_cumsum_ref(x)).abs()
    tol = 64 * torch.finfo(dtype).eps * torch.cumsum(x.abs(), 0)
    assert bool(torch.all(err <= tol))
    xi = torch.from_numpy(rng.integers(-8, 9, L)).to(dev, dtype)
    assert torch.equal(ss.blocked_cumsum(xi), blocked_cumsum_ref(xi))
    odd = xi[1:]
    assert odd.data_ptr() % 16 != 0
    assert torch.equal(ss.blocked_cumsum(odd), blocked_cumsum_ref(odd))


def test_empty_inputs_launch_nothing():
    dev = _cuda()
    before = (cs.placement.launches, ss.blocked_cumsum.launches)
    keys = torch.zeros(0, dtype=torch.int32, device=dev)
    offsets = torch.zeros((0, 5), dtype=torch.int32, device=dev)
    pos = cs.placement(keys, offsets, nbins=5, block_b=1024)
    assert pos.shape == (0,) and pos.dtype == torch.int32
    assert pos.device.type == "cuda"
    for dtype in (torch.float32, torch.float64):
        c = ss.blocked_cumsum(torch.zeros(0, dtype=dtype, device=dev))
        assert c.shape == (0,) and c.dtype == dtype
    assert (cs.placement.launches, ss.blocked_cumsum.launches) == before


def test_pallas_plan_equals_radix_plan_through_the_kernels():
    dev = _cuda()
    ii, jj, _, siz = dataset(1, scale=0.05)
    rows = torch.from_numpy((ii - 1).astype(np.int32)).to(dev)
    cols = torch.from_numpy((jj - 1).astype(np.int32)).to(dev)
    before = (hist.block_histogram.launches, cs.placement.launches)
    p = plan(rows, cols, (siz, siz), method="pallas")
    assert (hist.block_histogram.launches, cs.placement.launches) == (
        before[0] + 2, before[1] + 2)
    r = plan(rows, cols, (siz, siz), method="radix")
    for f in ("perm", "slot", "indices", "indptr", "nnz"):
        assert torch.equal(getattr(p, f), getattr(r, f)), f
    assert default_block_b(siz + 1) == 1 << 16


@pytest.mark.parametrize("accum", ["min", "max", "mean", "first", "last"])
def test_duplicate_modes_on_the_card_match_the_cpu(accum):
    dev = _cuda()
    ii, jj, _, siz = dataset(3, scale=0.02)
    vals = np.random.default_rng(5).integers(-20, 21, ii.shape[0]) \
        .astype(np.float64)
    S = matlab.fsparse(ii, jj, vals, (siz, siz), accum=accum)
    C = matlab.fsparse(ii, jj, vals, (siz, siz), accum=accum, device="cpu")
    assert S.data.device.type == dev.type
    assert torch.equal(S.data.cpu(), C.data)


def test_fill_pallas_matches_the_fused_fill_on_the_card():
    from repro_torch.kernels import assembly_ops

    _cuda()
    ii, jj, ss_, siz = dataset(2, scale=0.05)
    coo = coo_from_matlab(ii, jj, ss_, (siz, siz))
    pat = plan(coo.rows, coo.cols, coo.shape)
    before = ss.blocked_cumsum.launches
    A = assembly_ops.fill_pallas(pat, coo.vals)
    assert ss.blocked_cumsum.launches == before + 1
    assert torch.equal(A.data, assembly_ops.fill_fused(pat, coo.vals).data)


def test_sparse2_hit_launches_no_plan_kernel():
    _cuda()
    ii, jj, ss_, siz = dataset(1, scale=0.02)
    matlab.plan_cache_clear()
    A = matlab.sparse2(ii, jj, ss_, (siz, siz))
    before = (rs.digit_block_histogram.launches, rs.digit_placement.launches,
              ss.gather_segment_sum.launches)
    B = matlab.sparse2(ii, jj, ss_, (siz, siz))
    assert (rs.digit_block_histogram.launches, rs.digit_placement.launches,
            ss.gather_segment_sum.launches) == (before[0], before[1],
                                                before[2] + 1)
    info = matlab.plan_cache_info()
    assert (info["misses"], info["hits"]) == (1, 1)
    assert torch.equal(A.data, B.data)


@pytest.mark.parametrize("accum", ["min", "max"])
def test_min_max_gradient_on_card_matches_cpu(accum):
    dev = _cuda()
    rng = np.random.default_rng(22)
    rows = torch.from_numpy(rng.integers(0, 13, 300).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 9, 300).astype(np.int32))
    v = torch.from_numpy(rng.integers(-3, 4, 300).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    grads = []
    for d in ("cpu", dev):
        pat = plan(rows.to(d), cols.to(d), (12, 9), accum=accum)
        x = v.to(d).requires_grad_()
        (g,) = torch.autograd.grad((pat.assemble(x).data * w.to(d)).sum(), x)
        grads.append(g.cpu())
    assert torch.equal(grads[0], grads[1])


# ---------------------------------------------------------------------------
# Slice 3: the SpGEMM fill (B6), the ELL SpMV (B8), the symmetric streams
# (B9) and the BSR tiles (B10), on the FEM data of chip_smoke.py
# ---------------------------------------------------------------------------
def _fem(dev, n=15):
    """fem_poisson's P1 matrix (n x n cells) and a bilinear P, on ``dev``."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    rows, cols, vals, nv, f, _ = chip_smoke.fem_system(n)
    A = plan(torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev),
             (nv, nv)).assemble(torch.from_numpy(vals).to(dev))
    pr, pc, pv, pshape = chip_smoke.bilinear_prolongation(n)
    P = plan(torch.from_numpy(pr).to(dev), torch.from_numpy(pc).to(dev),
             pshape).assemble(torch.from_numpy(pv).to(dev))
    return A, P, torch.from_numpy(f).to(dev)


def _within(got, want, mag, c):
    """Two summation orders of c terms differ by at most c eps sum|t|."""
    eps = torch.finfo(got.dtype).eps
    return bool(torch.all((got - want).abs() <= c * eps * mag))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_product_fill_kernel_matches_plain_version(dtype):
    from repro_torch.kernels.segment_sum.ref import gather2_segment_sum_ref
    from repro_torch.sparse import convert, ops, product_plan

    dev = _cuda()
    A, P, _ = _fem(dev)
    Pt = convert(ops.transpose(P), "csc")
    rng = np.random.default_rng(31)
    for pp in (product_plan(Pt, A), product_plan(Pt, A, flops_max=20_000,
                                                 nzmax=700)):
        st = (pp.sa, pp.sb, pp.pattern.slot)
        nz = dict(num_segments=pp.nzmax)

        def vec(n, ints):
            x = rng.integers(-8, 9, n) if ints else rng.standard_normal(n)
            return torch.from_numpy(x).to(dev, dtype)

        va, vb = vec(Pt.nzmax, True), vec(A.nzmax, True)
        before = ss.gather2_segment_sum.launches
        got = ss.gather2_segment_sum(va, vb, *st, **nz)
        assert ss.gather2_segment_sum.launches == before + 1
        assert torch.equal(got, gather2_segment_sum_ref(va, vb, *st, **nz))
        va, vb = vec(Pt.nzmax, False), vec(A.nzmax, False)
        run = int(torch.bincount(pp.pattern.slot.long()).max())
        assert _within(ss.gather2_segment_sum(va, vb, *st, **nz),
                       gather2_segment_sum_ref(va, vb, *st, **nz),
                       gather2_segment_sum_ref(va.abs(), vb.abs(), *st, **nz),
                       run)
        # a NaN among integer-valued data: the rest is exact, so bit for bit
        va, vb = vec(Pt.nzmax, True), vec(A.nzmax, True)
        va[int(pp.sa[0])] = float("nan")
        got = ss.gather2_segment_sum(va, vb, *st, **nz)
        assert bool(torch.isnan(got).any())
        assert _same(got, gather2_segment_sum_ref(va, vb, *st, **nz))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_kernel_matches_plain_version(dtype):
    from repro_torch import kernels
    from repro_torch.kernels.spmv import spmv as ell
    from repro_torch.kernels.spmv.ref import spmv_ell_ref

    dev = _cuda()
    A, _, _ = _fem(dev, 40)
    cols, vals, overflow = kernels.csc_to_ell(A, max_per_row=7)
    assert not bool(overflow)
    vals = vals.to(dtype)
    rng = np.random.default_rng(32)
    xi = torch.from_numpy(rng.integers(-8, 9, A.N)).to(dev, dtype)
    before = ell.spmv_ell.launches
    assert torch.equal(ell.spmv_ell(cols, vals, xi),
                       spmv_ell_ref(cols, vals, xi))
    assert ell.spmv_ell.launches == before + 1
    x = torch.from_numpy(rng.standard_normal(A.N)).to(dev, dtype)
    assert _within(ell.spmv_ell(cols, vals, x), spmv_ell_ref(cols, vals, x),
                   spmv_ell_ref(cols, vals.abs(), x.abs()), 7)
    # a row of padding only, and an overflowing conversion
    _, _, over = kernels.csc_to_ell(A, max_per_row=3)
    assert bool(over)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sym_streams_kernel_matches_plain_version(dtype):
    sym = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import sym_streams_ref
    from repro_torch.sparse import convert

    dev = _cuda()
    A, _, _ = _fem(dev, 40)
    S = convert(A, "symcsc")
    # a padded tail past indptr[-1], sentinel rows, as a capacity leaves
    rows = torch.cat([S.indices, torch.full((9,), S.M, dtype=torch.int32,
                                            device=dev)])
    data = torch.cat([S.data, torch.zeros(9, device=dev)]).to(dtype)
    rng = np.random.default_rng(33)
    xi = torch.from_numpy(rng.integers(-8, 9, S.M)).to(dev, dtype)
    before = sym.sym_streams.launches
    for got, want in zip(sym.sym_streams(rows, data, S.indptr, xi),
                         sym_streams_ref(rows, data, S.indptr, xi)):
        assert torch.equal(got, want)
    assert sym.sym_streams.launches == before + 1
    x = torch.from_numpy(rng.standard_normal(S.M)).to(dev, dtype)
    (up, ct), (up0, ct0) = (sym.sym_streams(rows, data, S.indptr, x),
                            sym_streams_ref(rows, data, S.indptr, x))
    assert torch.equal(up, up0)  # one product a slot
    _, mag = sym_streams_ref(rows, data.abs(), S.indptr, x.abs())
    assert _within(ct, ct0, mag, int(torch.diff(S.indptr).max()))


@pytest.mark.parametrize("block", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsr_tiles_kernel_matches_plain_version(block, dtype):
    from repro_torch.core.csc import slot_columns
    sym = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import bsr_tiles_ref
    from repro_torch.sparse import convert

    dev = _cuda()
    rng = np.random.default_rng(34)
    n = 24 * block
    r = torch.from_numpy(rng.integers(0, n, 900).astype(np.int32)).to(dev)
    c = torch.from_numpy(rng.integers(0, n, 900).astype(np.int32)).to(dev)
    A = plan(r, c, (n, n)).assemble(torch.ones(900, device=dev))
    B = convert(A, "bsr", block=block)
    # one padding block (block row == Mb) at the end
    brows = torch.cat([B.indices, B.indices.new_full((1,), B.Mb)])
    data = torch.cat([B.data, B.data.new_ones((1, block, block))]).to(dtype)
    bcols = torch.cat([slot_columns(B.indptr, B.nbmax).clamp(0, B.Nb - 1),
                       B.indices.new_zeros(1)])
    xi = torch.from_numpy(rng.integers(-8, 9, n)).to(dev, dtype)
    before = sym.bsr_tiles.launches
    got = sym.bsr_tiles(brows, bcols, data, xi, Mb=B.Mb)
    assert sym.bsr_tiles.launches == before + 1
    assert torch.equal(got, bsr_tiles_ref(brows, bcols, data, xi, Mb=B.Mb))
    assert not bool(got[-1].any())
    x = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
    data = data * torch.from_numpy(rng.standard_normal(data.shape)).to(
        dev, dtype)
    assert _within(sym.bsr_tiles(brows, bcols, data, x, Mb=B.Mb),
                   bsr_tiles_ref(brows, bcols, data, x, Mb=B.Mb),
                   bsr_tiles_ref(brows, bcols, data.abs(), x.abs(), Mb=B.Mb),
                   block)


def test_slice3_wrong_lengths_and_types_raise_on_card():
    from repro_torch.kernels.assembly_ops import multiply_fused
    from repro_torch.kernels.spmv import spmv as ell
    sym = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.sparse import convert, ops, product_plan

    dev = _cuda()
    A, P, _ = _fem(dev)
    Pt = convert(ops.transpose(P), "csc")
    pp = product_plan(Pt, A)
    with pytest.raises(ValueError, match="data_A has shape"):
        pp.multiply(Pt.data[:-1], A.data)
    with pytest.raises(ValueError, match="data_B has shape"):
        pp.multiply(Pt.data, A.data[:7])
    with pytest.raises(ValueError, match="do not match the planned"):
        multiply_fused(pp, Pt.data[:-1], A.data)
    # complex operands run as real parts through B6 (no longer refused)
    got = pp.multiply(Pt.data.to(torch.complex64), A.data)
    want = pp.multiply(Pt.data, A.data)
    assert torch.equal(got.data.real, want.data)
    assert not bool(got.data.imag.any())
    i = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ell.spmv_ell(i, torch.zeros((4, 3), device=dev),
                     torch.zeros(5, device=dev))
    with pytest.raises(TypeError):
        ell.spmv_ell(i, torch.zeros((4, 2), device=dev),
                     torch.zeros(5, dtype=torch.float64, device=dev))
    S = convert(A, "symcsc")
    with pytest.raises(ValueError):
        sym.sym_streams(S.indices, S.data, S.indptr[:-1], torch.ones(
            S.M, device=dev))


def test_gradients_through_multiply_and_symcsc_on_card_match_cpu():
    import dataclasses

    from repro_torch.sparse import convert, ops, product_plan

    dev = _cuda()
    w_host = np.random.default_rng(35).integers(-3, 4, 10**5) \
        .astype(np.float32)
    grads = []
    for d in ("cpu", dev):
        A, P, _ = _fem(d)
        Pt = convert(ops.transpose(P), "csc")
        pp = product_plan(Pt, A)
        va = Pt.data.clone().requires_grad_()
        vb = A.data.clone().requires_grad_()
        w = torch.from_numpy(w_host[:pp.nzmax]).to(d)
        (pp.multiply(va, vb).data * w).sum().backward()
        S = convert(A, "symcsc")
        x = torch.from_numpy(w_host[:S.M].copy()).to(d).requires_grad_()
        diag = S.diag.clone().requires_grad_()
        data = S.data.clone().requires_grad_()
        y = ops.matmul(dataclasses.replace(S, diag=diag, data=data), x)
        (y * torch.arange(S.M, device=d)).sum().backward()
        grads.append([g.cpu() for g in (va.grad, vb.grad, x.grad, diag.grad,
                                        data.grad)])
    for a, b in zip(*grads):  # integer-valued: exact on both devices
        assert torch.equal(a, b)


def test_fem_path_on_card_matches_cpu_and_counts_launches():
    from repro_torch import kernels
    from repro_torch.kernels.spmv import spmv as ell
    sym = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.sparse import convert, ops, product_cache_clear

    dev = _cuda()
    out = {}
    for d in ("cpu", dev):
        A, P, f = _fem(d, 31)
        S, B = convert(A, "symcsc"), convert(A, "bsr", block=2)
        cols, vals, _ = kernels.csc_to_ell(A, max_per_row=7)
        x = torch.arange(A.N, dtype=torch.float32, device=d) % 7 - 3
        before = (ell.spmv_ell.launches, sym.sym_streams.launches,
                  sym.bsr_tiles.launches, ss.gather2_segment_sum.launches)
        ys = [ops.matmul(A, x), kernels.spmv(cols, vals, x),
              ops.matmul(S, x), ops.matmul(B, x)]
        product_cache_clear()
        Ac = ops.matmul(ops.matmul(ops.transpose(P), A), P)
        after = (ell.spmv_ell.launches, sym.sym_streams.launches,
                 sym.bsr_tiles.launches, ss.gather2_segment_sum.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (0, 0, 0, 0) if d == "cpu" else (1, 1, 1, 2))
        out[str(d)] = [y.cpu() for y in ys] + [Ac.data.cpu(),
                                               Ac.indices.cpu()]
    for a, b in zip(out["cpu"], out[str(dev)]):  # dyadic values: exact
        assert torch.equal(a, b)
    for y in out["cpu"][1:4]:
        assert torch.equal(y, out["cpu"][0])


# -- slice 4: the merge search B7, update and symmetric planning ----------
def _sorted_targets(n, M, N, rng, dev):
    tr = rng.integers(0, M + 1, n).astype(np.int32)  # M: the sentinel row
    tc = rng.integers(0, N, n).astype(np.int32)
    order = np.lexsort((tr, tc))
    return (torch.from_numpy(tr[order]).to(dev),
            torch.from_numpy(tc[order]).to(dev))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n,Lq", [(1, 5), (2, 255), (1000, 257),
                                  (100_003, 50_001)])
def test_merge_search_kernel_matches_plain_version(n, Lq, side):
    from repro_torch.kernels.merge import merge as mg
    from repro_torch.kernels.merge.ref import merge_search_ref

    dev = _cuda()
    rng = np.random.default_rng(n + Lq)
    M, N = 97, 61
    tr, tc = _sorted_targets(n, M, N, rng, dev)
    qr = torch.from_numpy(rng.integers(0, M + 1, Lq).astype(np.int32)).to(dev)
    qc = torch.from_numpy(rng.integers(0, N, Lq).astype(np.int32)).to(dev)
    # queries equal to targets: the ties the two sides tell apart
    k = min(n, Lq) // 2
    qr[:k], qc[:k] = tr[:k], tc[:k]
    before = mg.merge_search_kernel.launches
    got = mg.merge_search_kernel(qr, qc, tr, tc, side=side)
    torch.cuda.synchronize()
    assert mg.merge_search_kernel.launches == before + 1
    assert torch.equal(got, merge_search_ref(qr, qc, tr, tc, side=side))
    key = tc.long() * (M + 1) + tr.long()
    want = torch.searchsorted(key, qc.long() * (M + 1) + qr.long(),
                              right=side == "right")
    assert torch.equal(got.long(), want)


def test_merge_search_kernel_empty_and_bad_inputs():
    from repro_torch.kernels.merge import merge as mg

    dev = _cuda()
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    t = torch.arange(4, dtype=torch.int32, device=dev)
    before = mg.merge_search_kernel.launches
    assert torch.equal(mg.merge_search_kernel(t, t, z, z),
                       torch.zeros(4, dtype=torch.int32, device=dev))
    assert mg.merge_search_kernel(z, z, t, t).shape == (0,)
    assert mg.merge_search_kernel.launches == before
    with pytest.raises(TypeError):
        mg.merge_search_kernel(t.long(), t, t, t)
    with pytest.raises(ValueError):
        mg.merge_search_kernel(t, t[:3], t, t)
    with pytest.raises(ValueError, match="side"):
        mg.merge_search_kernel(t, t, t, t, side="middle")


def test_update_on_card_is_the_fresh_plan_and_counts_launches():
    from repro_torch.kernels.merge import merge as mg

    dev = _cuda()
    rng = np.random.default_rng(41)
    M, N, L, Ld = 3000, 2000, 200_000, 2_000
    rows = rng.integers(0, M + 1, L + Ld).astype(np.int32)
    cols = rng.integers(0, N, L + Ld).astype(np.int32)
    r, c = torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)
    base = plan(r[:L], c[:L], (M, N), nzmax=L + Ld)
    b7 = mg.merge_search_kernel.launches
    before = _launches()
    got = base.update(r[L:], c[L:])
    npass = len(ops.plan_digit_passes(M, N, Ld))
    assert _launches() == (before[0] + npass, before[1] + npass, before[2])
    assert mg.merge_search_kernel.launches == b7 + 1
    want = plan(r, c, (M, N), nzmax=L + Ld)
    for f in ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    drop = torch.from_numpy(rng.random(L) < 0.01).to(dev)
    got = base.update(r[L:], c[L:], drop_mask=drop)
    keep = torch.cat([~drop, torch.ones(Ld, dtype=torch.bool, device=dev)])
    want = plan(r[keep], c[keep], (M, N), nzmax=L + Ld)
    for f in ("perm", "slot", "indices", "indptr", "nnz"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    before = (_launches(), mg.merge_search_kernel.launches)
    empty = r[:0]
    assert base.update(empty, empty) is base
    assert (_launches(), mg.merge_search_kernel.launches) == before


def test_symmetric_planning_on_card_matches_cpu():
    from repro_torch.kernels.merge import merge as mg
    from repro_torch.sparse import (convert, fsparse, pattern_symmetric,
                                    plan_symmetric)

    dev = _cuda()
    A, _, _ = _fem(dev, 31)
    pat_cols = torch.repeat_interleave(
        torch.arange(A.N, device=dev), torch.diff(A.indptr.long()))
    rows = A.indices[:int(A.nnz)]
    pat = plan(rows, pat_cols.to(torch.int32), A.shape)
    before = mg.merge_search_kernel.launches
    assert pattern_symmetric(pat)
    assert mg.merge_search_kernel.launches == before + 2
    k = int(torch.nonzero(rows != pat_cols)[0, 0])  # one mirror removed
    keep = torch.arange(rows.shape[0], device=dev) != k
    assert not pattern_symmetric(plan(rows[keep], pat_cols[keep].to(
        torch.int32), A.shape))
    vals = A.data[:int(A.nnz)]
    Y = plan_symmetric(rows, pat_cols, A.shape).assemble(vals)
    S = convert(A, "symcsc")
    nz = int(S.nnz)
    assert int(Y.nnz) == nz and torch.equal(Y.diag, S.diag)
    assert torch.equal(Y.data[:nz], S.data) \
        and torch.equal(Y.indices[:nz], S.indices)
    ii = (rows + 1).cpu().numpy()
    jj = (pat_cols + 1).cpu().numpy()
    vv = vals.cpu().numpy()
    for fmt, kw in (("symcsc", {}), ("bsr", {"block": 2})):
        on_card = fsparse(ii, jj, vv, A.shape, format=fmt, **kw)
        on_cpu = fsparse(ii, jj, vv, A.shape, format=fmt, device="cpu", **kw)
        for f in ("data", "indices", "indptr", "nnz"):
            assert torch.equal(getattr(on_card, f).cpu(),
                               getattr(on_cpu, f)), (fmt, f)


# -- queue D, second pair: B2 with carried words, B12's key-ordered grid --

def _b2_case(dev, keys, kw, ncarry, payload):
    """B2 and its plain version on one pass, carrying ``ncarry`` words
    (the keys first); the placed prefix bit for bit."""
    base = ops.digit_bases(rs.digit_block_histogram(keys, **kw))
    rng = np.random.default_rng(keys.shape[0] + ncarry)
    other = torch.from_numpy(rng.integers(-9, 9, keys.shape[0])
                             .astype(np.int32)).to(dev)
    carry = (keys, other)[:ncarry]
    before = rs.digit_placement.launches
    got = rs.digit_placement(keys, base, payload, carry=carry, **kw)
    assert rs.digit_placement.launches == before + 1
    want = ref.digit_placement_ref(keys, base, payload, carry=carry,
                                   tile=rs.TILE, **kw)
    if carry:
        got, want = (got[0], *got[1]), (want[0], *want[1])
    else:
        got, want = (got,), (want,)
    d = (keys >> kw["shift"]) & ((1 << kw["bits"]) - 1)
    n = int((d < kw["nbins"]).sum())  # keys past nbins are never placed
    for a, b in zip(got, want):
        assert torch.equal(a[:n], b[:n])


@pytest.mark.parametrize("ncarry", [0, 1, 2])
@pytest.mark.parametrize("L", [1, rs.TILE - 1, 100_003])
@pytest.mark.parametrize("bits", range(1, 9))
def test_placement_with_carried_words_matches_plain_version(bits, L, ncarry):
    dev = _cuda()
    rng = np.random.default_rng(bits * 7 + L)
    keys = torch.from_numpy(rng.integers(0, 1 << 20, L).astype(np.int32)) \
        .to(dev)
    payload = torch.from_numpy(rng.permutation(L).astype(np.int32)).to(dev)
    for nbins in {1 << bits, max(1, (1 << bits) - 3)}:
        kw = dict(shift=5, bits=bits, nbins=nbins)
        for p in (None, payload):
            _b2_case(dev, keys, kw, ncarry, p)


def test_placement_at_the_5e7_sets_digits_carrying_words():
    """The 5e7 set's plan (M = N = 10^6: three 7/7/6-bit passes a word)
    on keys in [0, 10^6], each pass with the words the chain carries."""
    dev = _cuda()
    rng = np.random.default_rng(20)
    L, M = 3_000_017, 10**6
    keys = torch.from_numpy(rng.integers(0, M + 1, L).astype(np.int32)) \
        .to(dev)
    payload = torch.from_numpy(rng.permutation(L).astype(np.int32)).to(dev)
    passes = ops.plan_digit_passes(M, M, 5 * 10**7)
    assert [p.nbins for p in passes] == [128, 128, 62] * 2
    for i, p in enumerate(passes):
        ncarry = sum(ops.carried_words(passes, i))
        kw = dict(shift=p.shift, bits=p.bits, nbins=p.nbins)
        _b2_case(dev, keys, kw, ncarry, payload if i else None)


@pytest.mark.parametrize("M,N", [(700, 900), (10**6, 10**6), (3, 70_000)])
def test_carried_radix_sort_pair_on_card_counts_one_pair_per_pass(M, N):
    """One B1 and one B2 a planned pass, nothing else launched by the
    port's kernels, and the stable (col, row) order."""
    dev = _cuda()
    rng = np.random.default_rng(M + N)
    L = 1_000_003
    r = torch.from_numpy(rng.integers(0, M + 1, L).astype(np.int32)).to(dev)
    c = torch.from_numpy(rng.integers(0, N, L).astype(np.int32)).to(dev)
    before = _launches()
    perm = ops.radix_sort_pair(r, c, M=M, N=N)
    npass = len(ops.plan_digit_passes(M, N, L))
    assert _launches() == (before[0] + npass, before[1] + npass, before[2])
    assert torch.equal(perm, ref.radix_sort_pair_ref(r, c, M=M, N=N))


@pytest.mark.parametrize("L,block_b", [
    (1000, 1 << 20),              # L below one chunk of the grid
    (300_007, 100_003),           # block_b not a power of two
    (300_007, 3 * (1 << 14) + 5),  # a row of three chunks and a ragged one
    (50_007, 1000),               # rows shorter than a chunk
    (5_000_000, 1 << 20),         # the 5e7 set's block size
])
def test_block_histogram_global_path_matches_plain_version(L, block_b):
    """B12 past the shared-memory width (10^6 + 1 bins), with keys
    below 0 and at or past nbins, which count nowhere."""
    dev = _cuda()
    nbins = 1_000_001
    rng = np.random.default_rng(L + block_b)
    keys = rng.integers(-3, nbins + 3, L).astype(np.int32)
    keys[rng.integers(0, L, 20)] = np.iinfo(np.int32).max
    keys = torch.from_numpy(keys).to(dev)
    before = hist.block_histogram.launches
    h = hist.block_histogram(keys, nbins=nbins, block_b=block_b)
    assert hist.block_histogram.launches == before + 1
    assert torch.equal(h, block_histogram_ref(keys, nbins=nbins,
                                              block_b=block_b))
    inside = int(((keys >= 0) & (keys < nbins)).sum())
    assert int(h.sum()) == inside


# -- complex values through the float kernels (split into real parts) ----

@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_fills_spmvs_and_refills_on_card_match_cpu(dtype, ints):
    """``plan(...).assemble`` (sum, mean), ``fill_pallas``, the ELL,
    SymCSC and BSR SpMVs and a SpGEMM refill on complex values: the
    card's results (B3', B5, B8, B9, B10, B6 on the real parts) against
    the CPU's plain versions on the complex values; bit for bit on
    integer-valued data, each part within c eps sum|terms| otherwise."""
    from repro_torch import kernels
    from repro_torch.sparse import convert, ops, product_plan

    dev = _cuda()
    rng = np.random.default_rng(40 + int(ints))
    M, L = 2000, 30_000
    flat = rng.choice(M * M, size=L, replace=False)
    r, c = np.minimum(flat // M, flat % M), np.maximum(flat // M, flat % M)
    _, first = np.unique(r * M + c, return_index=True)
    r, c = r[np.sort(first)], c[np.sort(first)]
    draw = (lambda n: rng.integers(-4, 5, n)) if ints else \
        (lambda n: rng.standard_normal(n))
    v = draw(r.size) + 1j * draw(r.size)
    x = draw(M) + 1j * draw(M)
    rows_h = np.concatenate([r, c]).astype(np.int32)
    cols_h = np.concatenate([c, r]).astype(np.int32)
    vals_h = np.concatenate([v, v])

    def run(d):
        rows = torch.from_numpy(rows_h).to(d)
        cols = torch.from_numpy(cols_h).to(d)
        vals = torch.from_numpy(vals_h).to(d, dtype)
        xd = torch.from_numpy(x).to(d, dtype)
        pat = plan(rows, cols, (M, M))
        A = pat.assemble(vals)
        out = {"sum": A.data, "mean": plan(rows, cols, (M, M),
                                           accum="mean").assemble(vals).data,
               "fill_pallas": kernels.fill_pallas(pat, vals).data,
               "symcsc": ops.matmul(convert(A, "symcsc"), xd),
               "bsr": ops.matmul(convert(A, "bsr", block=2), xd)}
        ell_cols, ell_vals, _ = kernels.csc_to_ell(A, max_per_row=64)
        out["ell"] = kernels.spmv(ell_cols, ell_vals, xd)
        pp = product_plan(A, A)
        out["product"] = pp.multiply(A.data, A.data).data
        # sum|terms| of each result: the fills' |v|, the SpMVs' |A| |x|,
        # the product's |A| |A|
        fill_mag = pat.assemble(vals.abs()).data
        spmv_mag = kernels.spmv(ell_cols, ell_vals.abs(), xd.abs())
        mags = {"sum": fill_mag, "mean": fill_mag,
                "fill_pallas": vals.abs().sum().expand(fill_mag.shape),
                "ell": spmv_mag, "symcsc": spmv_mag, "bsr": spmv_mag,
                "product": pp.multiply(A.data.abs(), A.data.abs()).data}
        return ({k: t.cpu() for k, t in out.items()},
                {k: t.cpu() for k, t in mags.items()})

    got, mag = run(dev)
    want, _ = run("cpu")
    eps = torch.finfo(got["sum"].real.dtype).eps
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype == dtype, k
        if ints:
            assert torch.equal(g, w), k
            continue
        # each part within c eps sum|terms| (a part of a complex product
        # has twice the terms); fill_pallas differences B5's prefix sums,
        # whose error grows with the running sum (2 x 64 eps, bounded by
        # the total)
        c = 2 * 64 if k == "fill_pallas" else 16
        for part in (torch.real, torch.imag):
            err = (part(g) - part(w)).abs()
            assert bool(torch.all(err <= c * eps * 2 * mag[k] + 1e-30)), k


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_placement_on_words_not_16_byte_aligned(offset):
    """Views that start ``offset`` words into their storage take B2's
    4-byte copies instead of its 16-byte ones: the same result."""
    dev = _cuda()
    rng = np.random.default_rng(50 + offset)
    L = 100_003
    big = torch.from_numpy(rng.integers(0, 1 << 20, L + offset)
                           .astype(np.int32)).to(dev)
    keys = big[offset:]
    assert keys.data_ptr() % 16 != 0
    payload = torch.from_numpy(rng.permutation(L + offset)
                               .astype(np.int32)).to(dev)[offset:]
    kw = dict(shift=4, bits=7, nbins=128)
    for ncarry in (0, 1, 2):
        _b2_case(dev, keys, kw, ncarry, payload)


# ---------------------------------------------------------------------------
# B3' and B4 (single-pass segmented reduction) on the streams that break a
# tile design, from chip_smoke.ragged_slots: one run of 2^20, runs of
# random length 1..10^4, a run that starts at a tile's last position, a
# tile of only dropped slots, and the random stream on views that start 4
# bytes into their storage (4-byte loads instead of 16-byte ones).
# ---------------------------------------------------------------------------
def _smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def _unaligned(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    assert buf[1:].data_ptr() % 16 != 0
    return buf[1:]


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stream", ["one_run", "random", "tile_edge",
                                    "dropped_tile", "unaligned"])
def test_segment_kernels_on_runs_that_cross_tiles(stream, dtype, cut):
    """num_segments at nnz, or cut mid-stream (``cut``).  Sums bit for
    bit on integer-valued data, bit for bit from call to call on random
    data and there within C_SEG = 16 eps of each slot's sum|terms| of the
    exact sum (the kernel's first-order bound is (K + 12) eps / 2 = 10
    eps, K = 8: csrc/segment_sum.cu); min/max bit for bit, NaN
    included.  One launch a call."""
    dev = _cuda()
    smoke = _smoke()
    rng = np.random.default_rng(70)
    slot_np = smoke.ragged_slots("random" if stream == "unaligned"
                                 else stream, SEG_TILE, rng)
    perm, slot = smoke.slot_stream(slot_np, dev, 70)
    if stream == "unaligned":
        perm, slot = _unaligned(perm), _unaligned(slot)
    L = slot.numel()
    nnz = int(slot_np[slot_np < 2**30].max()) + 1
    n = nnz // 2 if cut else nnz
    kw = dict(num_segments=n)
    vi = torch.from_numpy(rng.integers(-8, 9, L)).to(dev, dtype)
    before = ss.gather_segment_sum.launches
    assert torch.equal(ss.gather_segment_sum(vi, perm, slot, **kw),
                       gather_segment_sum_ref(vi, perm, slot, **kw))
    assert ss.gather_segment_sum.launches == before + 1
    vn = torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
    got = ss.gather_segment_sum(vn, perm, slot, **kw)
    assert torch.equal(ss.gather_segment_sum(vn, perm, slot, **kw), got)
    eps = torch.finfo(dtype).eps
    assert smoke.seg_err_over_eps(got, vn, perm, slot, eps) <= smoke.C_SEG
    vn[[5, L // 3, L - 1]] = float("nan")
    for op in ("min", "max"):
        before = ss.gather_segment_minmax.launches
        got = ss.gather_segment_minmax(vn, perm, slot, op=op, **kw)
        assert ss.gather_segment_minmax.launches == before + 1
        assert _same(got, gather_segment_minmax_ref(vn, perm, slot, op=op,
                                                    **kw))


# ---------------------------------------------------------------------------
# B7 narrowed by blocks of queries and B9 on tiles of the merge of column
# ends and slots, on the streams that break those designs
# (chip_smoke.merge_streams, chip_smoke.sym_stream).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", ["sorted_few", "sorted_all", "random",
                                  "sparse_random", "edges", "below",
                                  "above", "n_1", "n_4095", "n_4096",
                                  "n_4097"])
def test_merge_search_kernel_on_block_narrowed_streams(kind, side):
    """Sorted queries (Lq << n and Lq = n), random ones (dense: a block's
    range is all of n; and sparse), ties and sentinel rows at the
    narrowed ranges' edges, every query below or above every target,
    n = 1, 2^k - 1, 2^k, 2^k + 1 and a ragged Lq: bit for bit against
    the plain ladder, torch.searchsorted of the packed keys and the
    dense shape's route in plain PyTorch; one launch a call."""
    from repro_torch.kernels.merge import merge as mg
    from repro_torch.kernels.merge.ref import (merge_search_narrowed_ref,
                                               merge_search_ref, pack_keys)

    dev = _cuda()
    smoke = _smoke()
    streams = smoke.merge_streams(kind, np.random.default_rng(81), mg.BLOCK_Q)
    qr, qc, tr, tc = (torch.from_numpy(a).to(dev) for a in streams[:4])
    before = mg.merge_search_kernel.launches
    got = mg.merge_search_kernel(qr, qc, tr, tc, side=side)
    torch.cuda.synchronize()
    assert mg.merge_search_kernel.launches == before + 1
    assert torch.equal(got, merge_search_ref(qr, qc, tr, tc, side=side))
    assert torch.equal(got, merge_search_narrowed_ref(qr, qc, tr, tc,
                                                      side=side))
    want = torch.searchsorted(pack_keys(tr, tc), pack_keys(qr, qc),
                              right=side == "right")
    assert torch.equal(got.long(), want)


@pytest.mark.parametrize("shape", ["path", "columns", "tiles"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["arrow", "tile_edge", "empty_runs"])
def test_sym_streams_kernel_on_streams_that_cross_tiles(kind, dtype, shape):
    """The arrow matrix (a column of 2^20 entries beside columns of 3), a
    column whose first slot is a tile's last item, runs of empty columns
    with sentinel rows and a padded tail: up and ct bit for bit on
    integer-valued data (also against the kernel's route in plain
    PyTorch); on random data up bit for bit, ct bit for bit from call to
    call and within C_SEG = 16 eps of each column's sum|terms| of the
    exact sum (first-order bound 10 eps: csrc/spmv_sym.cu); one launch a
    call.  In the shape the stream's longest column picks ("path"), and
    forced: a longest column of 1 takes one thread a column, an unknown
    one the tiles."""
    sym = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import (SYM_TILE, sym_shape,
                                                  sym_streams_ref,
                                                  sym_streams_tiled_ref)

    dev = _cuda()
    smoke = _smoke()
    rng = np.random.default_rng(82)
    rows_h, indptr_h, M = smoke.sym_stream(kind, SYM_TILE, rng)
    rows = torch.from_numpy(rows_h).to(dev)
    indptr = torch.from_numpy(indptr_h).to(dev)
    nz = rows.numel()

    def draw(k, ints):
        v = rng.integers(-8, 9, k) if ints else rng.standard_normal(k)
        return torch.from_numpy(v).to(dev, dtype)

    longest = int(torch.diff(indptr).max())
    long = kind in ("arrow", "tile_edge")  # a column of over 2 tiles
    assert sym_shape(longest, M, nz) == ("tiles" if long else "columns")
    assert sym_shape(1, M, nz) == "columns"
    kw = dict(longest={"path": longest, "columns": 1, "tiles": None}[shape])
    di, xi = draw(nz, True), draw(M, True)
    before = sym.sym_streams.launches
    got = sym.sym_streams(rows, di, indptr, xi, **kw)
    assert sym.sym_streams.launches == before + 1
    for want in (sym_streams_ref(rows, di, indptr, xi),
                 sym_streams_tiled_ref(rows, di, indptr, xi)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    d, x = draw(nz, False), draw(M, False)
    up, ct = sym.sym_streams(rows, d, indptr, x, **kw)
    assert torch.equal(up, sym_streams_ref(rows, d, indptr, x)[0])
    assert torch.equal(sym.sym_streams(rows, d, indptr, x, **kw)[1], ct)
    eps = torch.finfo(dtype).eps
    assert smoke.sym_err_over_eps(ct, rows, d, indptr, x, eps) <= smoke.C_SEG


# ---------------------------------------------------------------------------
# B6 (B3''s single-pass segmented reduction with two gathers) on the product
# streams that break a tile design (chip_smoke.product_stream: one run of
# 2^20, runs of random length 1..10^4, a run that starts at a tile's last
# position, a tile of only dropped slots, the random stream on views that
# start 4 bytes into their storage) and on B' B of the arrow matrix (a run
# of 2^16 products: its dense column's dot product with itself).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stream", ["one_run", "random", "tile_edge",
                                    "dropped_tile", "unaligned",
                                    "arrow_gram"])
def test_product_fill_kernel_on_runs_that_cross_tiles(stream, dtype):
    """Bit for bit against the plain version on integer-valued data, with
    and without a NaN; bit for bit from call to call on random data and
    there within C_SEG = 16 eps of each slot's sum|terms| of the exact
    sum of its rounded products (the first-order bound is (K + 12) eps /
    2: csrc/segment_sum.cu); one launch a call."""
    from repro_torch.kernels.segment_sum.ref import (PRODUCT_TILE,
                                                     gather2_segment_sum_ref)

    dev = _cuda()
    smoke = _smoke()
    rng = np.random.default_rng(90)
    if stream == "arrow_gram":
        pp, Bt, B = smoke.arrow_gram(dev, rng, dense=1 << 16)
        sa, sb, slot = pp.sa, pp.sb, pp.pattern.slot
        na, nb, n = Bt.nzmax, B.nzmax, pp.nzmax
    else:
        na = nb = 1 << 20
        st = smoke.product_stream("random" if stream == "unaligned"
                                  else stream, PRODUCT_TILE, rng, na)
        sa, sb, slot = (torch.from_numpy(x).to(dev) for x in st)
        if stream == "unaligned":
            sa, sb, slot = _unaligned(sa), _unaligned(sb), _unaligned(slot)
        n = int(st[2][st[2] < 2**30].max()) + 1
    kw = dict(num_segments=n)

    def draw(k, ints):
        x = rng.integers(-8, 9, k) if ints else rng.standard_normal(k)
        return torch.from_numpy(x).to(dev, dtype)

    va, vb = draw(na, True), draw(nb, True)
    before = ss.gather2_segment_sum.launches
    got = ss.gather2_segment_sum(va, vb, sa, sb, slot, **kw)
    assert ss.gather2_segment_sum.launches == before + 1
    assert torch.equal(got, gather2_segment_sum_ref(va, vb, sa, sb, slot,
                                                    **kw))
    kept = torch.nonzero((slot >= 0) & (slot < n)).flatten()
    va[int(sa[kept[kept.numel() // 2]])] = float("nan")
    got = ss.gather2_segment_sum(va, vb, sa, sb, slot, **kw)
    assert bool(torch.isnan(got).any())
    assert _same(got, gather2_segment_sum_ref(va, vb, sa, sb, slot, **kw))
    va, vb = draw(na, False), draw(nb, False)
    got = ss.gather2_segment_sum(va, vb, sa, sb, slot, **kw)
    assert torch.equal(ss.gather2_segment_sum(va, vb, sa, sb, slot, **kw),
                       got)
    eps = torch.finfo(dtype).eps
    assert smoke.product_err_over_eps(got, va, vb, sa, sb, slot,
                                      eps) <= smoke.C_SEG


@pytest.mark.parametrize("variant", ["replaced", "shipped", "K4", "K4_min8",
                                     "K8", "K8_min5", "K8_min4", "K12",
                                     "K12_min4", "K12_min3", "ldg",
                                     "K8_min6", "K12_min5"])
def test_product_probe_variants_match_plain_version(variant):
    """Each of B6's timing variants (csrc/segment_sum_probe.cu), and the
    two-gather floor's products, bit for bit on integer-valued data
    against the plain version, on runs of random length."""
    from repro_torch.kernels.segment_sum.ref import (PRODUCT_TILE,
                                                     gather2_segment_sum_ref)

    dev = _cuda()
    smoke = _smoke()
    assert set(smoke.PRODUCT_VARIANTS) == {
        "replaced", "shipped", "K4", "K4_min8", "K8", "K8_min5", "K8_min4",
        "K12", "K12_min4", "K12_min3", "ldg", "K8_min6", "K12_min5"}
    rng = np.random.default_rng(91)
    st = smoke.product_stream("random", PRODUCT_TILE, rng, 1 << 16)
    sa, sb, slot = (torch.from_numpy(x).to(dev) for x in st)
    n = int(st[2].max()) + 1
    va, vb = (torch.from_numpy(rng.integers(-8, 9, 1 << 16)).to(
        dev, torch.float32) for _ in range(2))
    want = gather2_segment_sum_ref(va, vb, sa, sb, slot, num_segments=n)
    got = smoke.product_probe(smoke.PRODUCT_VARIANTS[variant], va, vb, sa,
                              sb, slot, n)
    assert torch.equal(got, want)
    for v in (1, 2, 3):
        assert torch.equal(smoke.gather2_floor(va, vb, sa, sb, slot, n, v),
                           va[sa.long()] * vb[sb.long()])


# ---------------------------------------------------------------------------
# Slice 5: the policy layer and the analysis layer on the card
# ---------------------------------------------------------------------------
def test_resource_report_matches_the_declared_columns():
    """Every kernel instance's registers, shared bytes and resident
    blocks, read from its library, against the declared columns."""
    from repro_torch.sparse.analysis.vmem import check_report, vmem_report

    _cuda()
    rows = vmem_report()
    assert all(r["measured"] for r in rows)
    assert check_report(rows) == []
    assert all(r["smem_optin"] >= r["dynamic_smem"] for r in rows)


def test_resource_report_before_any_launch():
    """In a fresh process, before any kernel ran (so no launch has opted
    a kernel in to more than the default shared memory), the report
    still finds a resident block for every instance."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    _cuda()
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    code = ("from repro_torch.sparse.analysis.vmem import check_report, "
            "vmem_report\nbad = check_report(vmem_report())\n"
            "assert bad == [], bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_contract_audit_clean_on_the_card_and_catches_plants():
    from repro_torch.sparse import InvariantViolation, plan
    from repro_torch.sparse.analysis import (audit_default_paths,
                                             audit_jaxpr, record_ops)

    dev = _cuda()
    assert len(audit_default_paths()) == 22
    pat = plan(torch.tensor([0, 1, 0, 2, 2], device=dev),
               torch.tensor([0, 0, 1, 2, 2], device=dev), (3, 3))
    vals = torch.ones(pat.L, device=dev)
    audit_jaxpr(record_ops(pat.scatter, vals), expect_dtype=torch.float32)
    for plant in (lambda v: pat.scatter(v).cpu(),
                  lambda v: pat.scatter(v) * pat.nnz.item(),
                  lambda v: pat.scatter(v)[pat.scatter(v) > 0]):
        with pytest.raises(InvariantViolation, match="host-sync"):
            audit_jaxpr(record_ops(plant, vals))


def test_validators_on_card_tensors():
    import dataclasses

    from repro_torch.sparse import (InvariantViolation, convert, plan,
                                    product_plan, validate_matrix,
                                    validate_pattern)

    dev = _cuda()
    rng = np.random.default_rng(5)
    r = torch.from_numpy(rng.integers(0, 300, 5000)).to(dev)
    c = torch.from_numpy(rng.integers(0, 300, 5000)).to(dev)
    pat = validate_pattern(plan(r, c, (300, 300)))
    A = validate_matrix(pat.assemble(torch.ones(5000, device=dev)))
    for fmt in ("csr", "coo"):
        validate_matrix(convert(A, fmt))
    validate_pattern(product_plan(A, A))
    perm = pat.perm.clone()
    perm[0] = perm[1]
    with pytest.raises(InvariantViolation, match="perm-permutation"):
        validate_pattern(dataclasses.replace(pat, perm=perm))


@pytest.mark.parametrize("shape", ["dense", "sparse", "ladder"])
def test_every_b7_shape_gives_the_same_offsets(shape):
    """The shape the caller passes (from its resolved thresholds) changes
    B7's launch, never its offsets."""
    from repro_torch.kernels.merge.merge import merge_search_kernel
    from repro_torch.kernels.merge.ref import merge_search_ref

    dev = _cuda()
    rng = np.random.default_rng(17)
    key = np.sort(rng.integers(0, 1 << 40, 1 << 20))
    tr = torch.from_numpy((key & 0xFFFFF).astype(np.int32)).to(dev)
    tc = torch.from_numpy((key >> 20).astype(np.int32)).to(dev)
    q = rng.integers(0, 1 << 20, (2, 5000)).astype(np.int32)
    qr, qc = (torch.from_numpy(x).to(dev) for x in q)
    for side in ("left", "right"):
        assert torch.equal(
            merge_search_kernel(qr, qc, tr, tc, side=side, shape=shape),
            merge_search_ref(qr, qc, tr, tc, side=side))


def test_measure_sweep_on_the_card_holds_every_candidate(tmp_path):
    """``--measure`` on the card at a small scale: every candidate of
    every family agrees with the prior's output, one a call-site
    decision is timed, and none names a plain method on the card."""
    from repro_torch.sparse import tuning
    from repro_torch.sparse.tuning.__main__ import run_measure

    _cuda()
    tuning.set_table(tuning.TuningTable())
    try:
        results = run_measure(scale=0.1, min_gain=10.0, log=lambda s: None)
        assert {r["family"] for r in results} == {
            "plan", "radix_sort", "counting_sort", "merge", "spmv_sym"}
        assert all(c["ms"] > 0 for r in results for c in r["candidates"])
        for r in results:
            hows = [c["decision"] for c in r["candidates"]]
            assert len(hows) == len({str(h) for h in hows})
            if r["family"] in ("plan", "merge"):
                assert {c["policy"]["method"] for c in r["candidates"]} <= {
                    "radix", "pallas"}
        assert len(tuning.get_table()) == 0  # no gain beats 1000%
    finally:
        tuning.reset_table()


# ---------------------------------------------------------------------------
# The plan service's executable tier: CUDA graphs against eager calls
# ---------------------------------------------------------------------------
def _serving_operands(dev, n=64, seed=31):
    """One symmetric matrix with integer values on the card, in every
    format the tier captures, and a second operand for the product."""
    from repro_torch.sparse import convert, fsparse

    rng = np.random.default_rng(seed)
    r0, c0 = rng.integers(1, n + 1, (2, 400))
    v0 = rng.integers(-4, 5, 400).astype(np.float32)
    S = fsparse(np.concatenate([r0, c0]), np.concatenate([c0, r0]),
                np.concatenate([v0, v0]), (n, n), device=dev)
    B = fsparse(*rng.integers(1, n + 1, (2, 300)),
                rng.integers(-4, 5, 300).astype(np.float32), (n, n),
                device=dev)
    return {"csc": S, "csr": convert(S, "csr"),
            "symcsc": convert(S, "symcsc"),
            "bsr": convert(S, "bsr", block=2)}, B


@pytest.mark.parametrize("accum", ["sum", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_captured_fill_replays_bit_for_bit_and_results_survive(dtype, accum):
    from repro_torch.sparse import plan
    from repro_torch.sparse.serving import Executable, GraphCounts

    dev = _cuda()
    rng = np.random.default_rng(5)
    L, n = 200_000, 3000
    r, c = (torch.from_numpy(rng.integers(0, n, L).astype(np.int32)).to(dev)
            for _ in range(2))
    pat = plan(r, c, (n, n), accum=accum)
    counts = GraphCounts()
    v1, v2 = (torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
              for _ in range(2))
    ex = Executable(pat.scatter, (v1,), kind="fill", counts=counts)
    assert ex.graph is not None
    before = ss.gather_segment_sum.launches + \
        ss.gather_segment_minmax.launches
    y1 = ex(v1)
    y2 = ex(v2)                     # a later replay must not touch y1
    torch.cuda.synchronize()
    assert ss.gather_segment_sum.launches + \
        ss.gather_segment_minmax.launches == before   # replays launch none
    assert torch.equal(y1, pat.scatter(v1))
    assert torch.equal(y2, pat.scatter(v2))
    assert counts.info() == {"captures": {"fill": 1},
                             "replays": {"fill": 2}}


def test_captured_multiply_and_spmv_replay_as_eager():
    from repro_torch.sparse import PlanService, ops

    dev = _cuda()
    fmts, B = _serving_operands(dev)
    svc = PlanService()
    A = fmts["csc"]
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(6)
        Ad = dataclasses.replace(A, data=torch.from_numpy(
            rng.standard_normal(A.nzmax)).to(dev, dtype))
        Bd = dataclasses.replace(B, data=torch.from_numpy(
            rng.standard_normal(B.nzmax)).to(dev, dtype))
        C = svc.multiply(Ad, Bd)
        assert torch.equal(C.data, ops.matmul(Ad, Bd).data)
        assert torch.equal(svc.multiply(Ad, Bd).data, C.data)
    xi = torch.from_numpy(np.arange(-32, 32, dtype=np.float32)).to(dev)
    xr = torch.from_numpy(np.random.default_rng(8).standard_normal(64)
                          .astype(np.float32)).to(dev)
    for name, S in fmts.items():
        y = svc.spmv(S, xi)         # integer-valued: exact either way
        assert torch.equal(y, ops.matmul(S, xi)), name
        assert torch.equal(svc.spmv(S, xi), y), name
        absS = ops.matmul(dataclasses.replace(A, data=A.data.abs()),
                          xr.abs())
        err = (svc.spmv(S, xr) - ops.matmul(S, xr)).abs()
        assert bool(torch.all(
            err <= 8 * torch.finfo(torch.float32).eps * absS)), name
    X = torch.stack([xi, 2 * xi], 1)
    assert torch.equal(svc.spmv(fmts["symcsc"], X),
                       ops.matmul(fmts["symcsc"], X))
    st = svc.stats()
    assert st["graph_mode"] == "cuda-graph"
    assert all(ex.graph is not None for _, ex in svc._execs.items())
    assert st["graphs"]["captures"] == {"multiply": 2, "spmv": 5}


def test_four_threads_replaying_one_entry():
    import threading

    from repro_torch.sparse import PlanService, fsparse

    dev = _cuda()
    rng = np.random.default_rng(9)
    n, L = 2000, 100_000
    ii, jj = rng.integers(1, n + 1, (2, L))
    ss = rng.integers(-8, 9, L).astype(np.float32)
    svc = PlanService()
    want = {k: fsparse(ii, jj, ss * k, (n, n), device=dev).data
            for k in range(1, 5)}
    svc.assemble(ii, jj, ss, (n, n))
    errors = []

    def worker(t):
        try:
            for r in range(8):
                k = 1 + (t + r) % 4
                got = svc.assemble(ii, jj, ss * k, (n, n))
                if not torch.equal(got.data, want[k]):
                    errors.append((t, r))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert svc.stats()["graphs"] == {"captures": {"fill": 1},
                                     "replays": {"fill": 33}}


def test_a_failed_capture_raises():
    from repro_torch.sparse.serving import Executable

    dev = _cuda()
    x = torch.ones(16, device=dev)
    with pytest.raises(RuntimeError):
        Executable(lambda v: v * float(v.sum()), (x,))  # a host sync
    torch.cuda.synchronize()
    assert torch.equal(x + 1, torch.full((16,), 2.0, device=dev))


def test_spmv_key_memo_follows_an_in_place_change():
    from repro_torch.sparse import PlanService, ops
    from repro_torch.sparse.spgemm import _structure_key

    dev = _cuda()
    fmts, _ = _serving_operands(dev)
    S = fmts["csc"]
    svc = PlanService()
    x = torch.arange(64, dtype=torch.float32, device=dev)
    y = svc.spmv(S, x)
    k1 = svc._structure_keys(S)
    assert svc._structure_keys(S) is k1
    nnz = int(S.nnz)
    S.indices[:nnz] = S.indices[:nnz].flip(0)   # another structure
    k2 = svc._structure_keys(S)
    assert k2 != k1 and k2 == _structure_key(S)
    assert torch.equal(svc.spmv(S, x), ops.matmul(S, x))
    assert not torch.equal(svc.spmv(S, x), y)
    assert svc.stats()["graphs"]["captures"] == {"spmv": 2}


def test_service_hits_pass_the_contract_audit_on_the_card():
    """On the card a hit copies nothing to the host: the memoised keys
    keep ``.cpu()`` of the structure out of every replayed request."""
    from repro_torch.sparse import PlanService, fsparse
    from repro_torch.sparse.analysis.contracts import (audit_trace,
                                                       record_ops)

    dev = _cuda()
    fmts, B = _serving_operands(dev)
    svc = PlanService()
    x = torch.ones(64, device=dev)
    rng = np.random.default_rng(11)
    ii, jj = rng.integers(1, 65, (2, 500))
    ss = rng.integers(-4, 5, 500).astype(np.float32)
    paths = {"assemble": lambda: svc.assemble(ii, jj, ss, (64, 64)).data,
             "multiply": lambda: svc.multiply(fmts["csc"], B).data,
             **{f"spmv[{f}]": (lambda S=S: svc.spmv(S, x))
                for f, S in fmts.items()}}
    for name, fn in paths.items():
        fn()
        assert audit_trace(record_ops(fn), name=name)["ok"]
    assert torch.equal(svc.assemble(ii, jj, ss, (64, 64)).data,
                       fsparse(ii, jj, ss, (64, 64), device=dev).data)


def test_audit_retraces_on_the_card():
    from repro_torch.sparse.analysis import audit_retraces

    _cuda()
    assert audit_retraces()["traces"] == 2


# -- the sharded path (sparse/sharded.py) on the card ------------------------
def _sharded_case(p, dev):
    from repro_torch.launch import make_data_mesh
    from repro_torch.sparse import plan_sharded

    ii, jj, _, siz = dataset(1, seed=42, scale=0.01)
    rows = torch.from_numpy((ii - 1).astype(np.int32))
    cols = torch.from_numpy((jj - 1).astype(np.int32))
    before = _launches()
    pat = plan_sharded(rows.to(dev), cols.to(dev), (siz, siz),
                       mesh=make_data_mesh(p))
    planned = tuple(a - b for a, b in zip(_launches(), before))
    cpu = plan_sharded(rows, cols, (siz, siz),
                       mesh=make_data_mesh(p, device="cpu"))
    return pat, cpu, planned, siz


@pytest.mark.parametrize("p", [1, 4])
def test_sharded_plan_on_the_card_matches_the_cpu(p):
    dev = _cuda()
    pat, cpu, planned, siz = _sharded_case(p, dev)
    assert pat.mesh.device.type == "cuda" and pat.p == p
    for f in ("send_slot", "perm", "slot", "indices", "indptr", "nnz",
              "send_base", "block_load", "overflow"):
        assert torch.equal(getattr(pat, f).cpu(), getattr(cpu, f)), f
    npass = len(ops.plan_digit_passes(pat.rpb, siz, int(pat.perm.shape[1])))
    assert planned == (p * npass, p * npass, 0)


@pytest.mark.parametrize("p", [1, 4])
def test_sharded_fill_on_the_card_is_one_b3_launch_a_row(p):
    dev = _cuda()
    pat, cpu, _, siz = _sharded_case(p, dev)
    rng = np.random.default_rng(p)
    vi = torch.from_numpy(rng.integers(-9, 10, pat.L).astype(np.float32))
    b3 = ss.gather_segment_sum.launches
    A = pat.assemble(vi.to(dev))
    assert ss.gather_segment_sum.launches == b3 + 1
    assert torch.equal(A.data.cpu(), cpu.assemble(vi).data)
    vb = torch.from_numpy(rng.standard_normal((3, pat.L)).astype(np.float32))
    Ab = pat.assemble_batch(vb.to(dev))
    assert ss.gather_segment_sum.launches == b3 + 4
    want = cpu.assemble_batch(vb).data
    mag = cpu.assemble_batch(vb.abs()).data
    eps = float(np.finfo(np.float32).eps)
    assert bool(((Ab.data.cpu() - want).abs() <= 16 * eps * mag).all())
    x = torch.from_numpy(rng.standard_normal(siz).astype(np.float32))
    A1 = Ab.batch_select(0)
    y = A1.spmv(x.to(dev)).cpu()
    y_cpu = cpu.assemble(vb[0]).spmv(x)
    bound = A1.to_dense().abs().cpu() @ x.abs()
    assert bool(((y - y_cpu).abs() <= 8 * eps * bound).all())


def test_sharded_gradient_on_the_card_is_the_cpu_one():
    dev = _cuda()
    pat, cpu, _, _ = _sharded_case(4, dev)
    rng = np.random.default_rng(9)
    v = torch.from_numpy(rng.standard_normal(pat.L).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((pat.p, pat.nzb))
                         .astype(np.float32))
    grads = []
    for P, vv, ww in ((pat, v.to(dev), w.to(dev)), (cpu, v, w)):
        vv = vv.clone().requires_grad_()
        (P.assemble(vv).data * ww).sum().backward()
        grads.append(vv.grad.cpu())
    assert torch.equal(grads[0], grads[1])


def test_sharded_facade_on_the_card_matches_fsparse():
    from repro_torch.launch import make_data_mesh
    from repro_torch.sparse import PlanService, convert, sparse2

    dev = _cuda()
    ii, jj, ss_, siz = dataset(2, seed=42, scale=0.01)
    F = matlab.fsparse(ii, jj, ss_, (siz, siz))
    nnz = int(F.nnz)
    matlab.plan_cache_clear()
    for p in (1, 4):
        mesh = make_data_mesh(p)
        S = matlab.fsparse(ii, jj, ss_, (siz, siz), method="sharded",
                           mesh=None if p == 1 else mesh)
        C = convert(S, "csc")
        assert S.data.device.type == "cuda" and S.n_blocks == p
        assert torch.equal(C.indptr, F.indptr) and int(C.nnz) == nnz
        assert torch.equal(C.data[:nnz], F.data[:nnz])
        assert torch.equal(C.indices[:nnz], F.indices[:nnz])
        for _ in range(2):
            S2 = sparse2(ii, jj, ss_, (siz, siz), method="sharded",
                         mesh=mesh)
        assert torch.equal(S2.data, S.data)
    info = matlab.plan_cache_info()
    assert (info["misses"], info["hits"]) == (2, 2)
    svc = PlanService()
    A = svc.assemble(ii, jj, ss_, (siz, siz), method="sharded")
    assert torch.equal(A.data, matlab.fsparse(ii, jj, ss_, (siz, siz),
                                              method="sharded").data)
    assert svc.stats()["graphs"]["captures"] == {}
    matlab.plan_cache_clear()


# ---------------------------------------------------------------------------
# The LM serving path: the MoE dispatch on B12/B11, the model, the
# embedding gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L", [8, 32, 8192, 8193, 16384, 2**16 + 1])
@pytest.mark.parametrize("nbins", [64, 256])
def test_counting_sort_at_moe_shapes(nbins, L):
    dev = _cuda()
    keys = torch.from_numpy(np.random.default_rng(L + nbins).integers(
        0, nbins, L).astype(np.int32))
    before = (hist.block_histogram.launches, cs.placement.launches)
    rank, pos = counting_sort(keys.to(dev), nbins=nbins)
    assert (hist.block_histogram.launches - before[0],
            cs.placement.launches - before[1]) == (1, 1)
    rank_p, pos_p = counting_sort(keys, nbins=nbins)  # the plain route
    assert torch.equal(rank.cpu(), rank_p) and torch.equal(pos.cpu(), pos_p)
    assert torch.equal(rank.long(), torch.argsort(keys.to(dev),
                                                  stable=True))


@pytest.mark.parametrize("G,L,E,C", [(1, 32, 64, 8), (1, 16384, 64, 320),
                                     (4, 16384, 64, 80), (2, 1000, 8, 96)])
def test_moe_dispatch_on_the_card_matches_the_cpu(G, L, E, C):
    from repro_torch.models import moe

    dev = _cuda()
    e = torch.from_numpy(np.random.default_rng(L).integers(
        0, E, (G, L // G)).astype(np.int32))
    got = moe._group_dispatch(e.to(dev), n_experts=E, capacity=C, groups=G)
    want = moe._group_dispatch(e, n_experts=E, capacity=C, groups=G)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    if G == 1:
        s, ld = moe.moe_dispatch_indices(e[0].to(dev), n_experts=E,
                                         capacity=C)
        assert torch.equal(s.cpu(), want[0][0])
        assert torch.equal(ld.cpu(), want[1][0])


def test_reduced_olmoe_prefill_and_decode_on_the_card_match_the_cpu():
    """float32 logits within 1e-4 of max|logit| of the CPU's (the card's
    float32 matmuls add in another order)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as lm

    dev = _cuda()
    cfg = get_config("olmoe_1b_7b").reduced(dtype="float32")
    p_cpu = lm.init_model(cfg, seed=0, device="cpu")
    p_dev = copy.deepcopy(p_cpu).to(dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32))
    before = cs.placement.launches
    with torch.inference_mode():
        out = {}
        for d, p in (("cpu", p_cpu), ("cuda", p_dev)):
            logits, cache = lm.prefill(p, {"tokens": toks.to(d)}, cfg,
                                       kv_chunk=8, extra_cache=3)
            steps = [logits]
            for i in range(3):
                nt = torch.from_numpy(np.full((2, 1), 7 * i + 1, np.int32))
                logits, cache = lm.decode_step(p, cache, nt.to(d), cfg)
                steps.append(logits)
            out[d] = [s.cpu() for s in steps]
    assert cs.placement.launches - before == 4 * cfg.n_layers
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


@pytest.mark.parametrize("upstream", ["integer", "random"])
def test_embedding_gradient_on_the_card_matches_the_cpu(upstream):
    """Bit for bit on integer-valued gradients; otherwise within
    ``2 (n - 1) eps sum|g|`` per row (the bound of each side's sum)."""
    from repro_torch.train import sparse_grad_embed

    dev = _cuda()
    V, D, T = 50_432, 64, 2048
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(np.where(
        rng.random(T) < 0.5, rng.integers(0, 16, T),
        rng.integers(0, V, T)).astype(np.int32))
    g = rng.integers(-64, 64, (T, D)) if upstream == "integer" \
        else rng.standard_normal((T, D))
    g = torch.from_numpy(g.astype(np.float32))
    grads = []
    for d in (dev, torch.device("cpu")):
        table = torch.zeros((V, D), device=d, requires_grad=True)
        (sparse_grad_embed(table, toks.to(d)) * g.to(d)).sum().backward()
        grads.append(table.grad.cpu())
    if upstream == "integer":
        assert torch.equal(grads[0], grads[1])
        return
    n = torch.bincount(toks.long(), minlength=V)[:, None].double()
    abs_sum = torch.zeros((V, D), dtype=torch.float64).index_add_(
        0, toks.long(), g.abs().double())
    eps = float(np.finfo(np.float32).eps)
    bound = 2 * (n - 1).clamp(min=0) * eps * abs_sum
    assert bool(((grads[0] - grads[1]).abs().double() <= bound).all())


# ---------------------------------------------------------------------------
# The LM training path: the train step and its checkpoints on the card
# ---------------------------------------------------------------------------
def _reduced_train_states(dev, tcfg):
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as lm
    from repro_torch.train import init_train_state

    cfg = get_config("olmoe_1b_7b").reduced(dtype="float32")
    p_cpu = lm.init_model(cfg, seed=0, device="cpu")
    p_dev = copy.deepcopy(p_cpu).to(dev)
    return cfg, init_train_state(p_cpu, tcfg), init_train_state(p_dev, tcfg)


def test_reduced_train_step_on_the_card_matches_the_cpu():
    """Loss and ``grad_norm`` within 1e-4 of the CPU's over two steps
    (the card's float32 matmuls add in another order); B12 and B11 run
    once per MoE layer call in the forward and in the recompute, and
    once for the embedding gradient, per microbatch."""
    from repro_torch.train import TrainConfig, make_train_step

    dev = _cuda()
    tcfg = TrainConfig(microbatches=2, compress_grads=True, kv_chunk=8)
    cfg, s_cpu, s_dev = _reduced_train_states(dev, tcfg)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    step = make_train_step(cfg, tcfg)
    for _ in range(2):
        before = (hist.block_histogram.launches, cs.placement.launches)
        s_dev, m_dev = step(s_dev, {k: v.to(dev) for k, v in batch.items()})
        per_step = tcfg.microbatches * (2 * cfg.n_layers + 1)
        assert (hist.block_histogram.launches - before[0],
                cs.placement.launches - before[1]) == (per_step, per_step)
        s_cpu, m_cpu = step(s_cpu, batch)
        for k in ("loss", "grad_norm"):
            assert abs(float(m_dev[k]) - float(m_cpu[k])) <= \
                1e-4 * abs(float(m_cpu[k])), k
    assert int(s_dev["step"]) == 2 and s_dev["step"].device.type == "cuda"


def test_train_state_checkpoint_on_the_card_round_trips(tmp_path):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models.layers import stacked_leaves
    from repro_torch.train import TrainConfig, make_train_step

    dev = _cuda()
    tcfg = TrainConfig(microbatches=1, compress_grads=True, kv_chunk=8)
    cfg, _, state = _reduced_train_states(dev, tcfg)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)).to(dev) for k in ("tokens", "labels")}
    state, _ = make_train_step(cfg, tcfg)(state, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    _, _, fresh = _reduced_train_states(dev, tcfg)
    restored, manifest = mgr.restore(fresh)
    assert restored is fresh and manifest["step"] == 1
    for (n, a, _), (_, b, _) in zip(stacked_leaves(state),
                                    stacked_leaves(restored)):
        assert all(y.device.type == "cuda" and x.dtype == y.dtype
                   and torch.equal(x, y) for x, y in zip(a, b)), n


# ---------------------------------------------------------------------------
# The ssm and hybrid families: the chunked scan, a reduced model's forward
# and its loss_fn gradients on the card against the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,groups", [(37, 1), (37, 2), (5, 2), (1, 1)])
def test_ssd_chunked_on_the_card_matches_the_cpu(S, groups):
    """float32 within 1e-5 of the CPU's largest magnitude (the card's
    batched matmuls and cumsum add in another order; TF32 stays off)."""
    from repro_torch.models.ssm import ssd_chunked

    dev = _cuda()
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(S + groups)
    B, H, P, N = 2, 4, 8, 6
    args = [rng.normal(size=(B, S, H, P)),
            np.log1p(np.exp(rng.normal(size=(B, S, H)))),
            -np.exp(rng.normal(size=(H,))),
            rng.normal(size=(B, S, groups, N)),
            rng.normal(size=(B, S, groups, N))]
    args = [torch.from_numpy(a.astype(np.float32)) for a in args]
    want = ssd_chunked(*args, chunk=16)
    got = ssd_chunked(*(a.to(dev) for a in args), chunk=16)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert float((g.cpu() - w).abs().max() / w.abs().max()) <= 1e-5


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
def test_reduced_ssm_forward_and_gradients_on_the_card_match_the_cpu(arch):
    """float32 logits and every gradient leaf within 1e-4 of the CPU's
    largest (the card's float32 matmuls add in another order); B12 and
    B11 run once each, for the embedding gradient."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as lm
    from repro_torch.models.layers import tree_leaves

    dev = _cuda()
    cfg = get_config(arch).reduced(dtype="float32", n_layers=4)
    p_cpu = lm.init_model(cfg, seed=0, device="cpu")
    p_dev = copy.deepcopy(p_cpu).to(dev)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 21)).astype(
        np.int32)) for k in ("tokens", "labels")}
    out = {}
    for d, p in (("cpu", p_cpu), ("cuda", p_dev)):
        b = {k: v.to(d) for k, v in batch.items()}
        with torch.inference_mode():
            logits, _ = lm.forward(p, b, cfg, kv_chunk=8)
        before = (hist.block_histogram.launches, cs.placement.launches)
        loss = lm.loss_fn(p, b, cfg, kv_chunk=8)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        if d == "cuda":
            assert (hist.block_histogram.launches - before[0],
                    cs.placement.launches - before[1]) == (1, 1)
        out[d] = (logits.cpu(), float(loss), [g.cpu() for g in grads])
    (lc, loss_c, gc), (lg, loss_g, gg) = out["cpu"], out["cuda"]
    assert float((lg - lc).abs().max() / lc.abs().max()) <= 1e-4
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)) <= 1e-4


# ---------------------------------------------------------------------------
# The encdec and vlm families: a reduced model's forward, decode and
# loss_fn gradients, and the embedding gradient at their vocabularies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["seamless_m4t_medium",
                                  "llama_3_2_vision_11b"])
def test_reduced_encdec_vlm_forward_and_gradients_on_the_card_match_the_cpu(
        arch):
    """float32 logits, a decode step after the prefill and every
    gradient leaf within 1e-4 of the CPU's largest (the card's float32
    matmuls add in another order); a source of 9 positions against 12
    tokens, 13 vision tokens in chunks of 8, two cross blocks; B12 and
    B11 run once each, for the embedding gradient."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as lm
    from repro_torch.models.layers import tree_leaves

    dev = _cuda()
    kw = {"n_layers": 4, "n_vision_tokens": 13} \
        if arch == "llama_3_2_vision_11b" else {}
    cfg = get_config(arch).reduced(dtype="float32", **kw)
    p_cpu = lm.init_model(cfg, seed=0, device="cpu")
    p_dev = copy.deepcopy(p_cpu).to(dev)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(
        np.int32)) for k in ("tokens", "labels")}
    key, n = ("src_embeds", 9) if cfg.family == "encdec" else \
        ("vision_embeds", cfg.n_vision_tokens)
    batch[key] = torch.from_numpy(rng.normal(size=(2, n, cfg.d_model)).astype(
        np.float32))
    out = {}
    for d, p in (("cpu", p_cpu), ("cuda", p_dev)):
        b = {k: v.to(d) for k, v in batch.items()}
        with torch.inference_mode():
            logits, _ = lm.forward(p, b, cfg, kv_chunk=8)
            _, cache = lm.prefill(p, b, cfg, kv_chunk=8, extra_cache=1)
            step, _ = lm.decode_step(p, cache, b["tokens"][:, :1], cfg)
        before = (hist.block_histogram.launches, cs.placement.launches)
        loss = lm.loss_fn(p, b, cfg, kv_chunk=8)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        if d == "cuda":
            assert (hist.block_histogram.launches - before[0],
                    cs.placement.launches - before[1]) == (1, 1)
        out[d] = (logits.cpu(), step.cpu(), float(loss),
                  [g.cpu() for g in grads])
    (lc, sc, loss_c, gc), (lg, sg, loss_g, gg) = out["cpu"], out["cuda"]
    assert float((lg - lc).abs().max() / lc.abs().max()) <= 1e-4
    assert float((sg - sc).abs().max() / sc.abs().max()) <= 1e-4
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)) <= 1e-4


@pytest.mark.parametrize("upstream", ["integer", "random"])
@pytest.mark.parametrize("V", [128_256, 256_256])
def test_embedding_gradient_at_wide_vocabularies(V, upstream):
    """Llama-3.2-Vision's and Seamless's padded vocabularies: above the
    shared memory a block can opt into, B12 counts in global memory.
    B12 and B11 on a microbatch's 2,048 token ids bit for bit against
    their plain versions on the card; the gradient bit for bit against
    the CPU on integer-valued gradients, else within ``2 (n - 1) eps
    sum|g|`` per row."""
    from repro_torch.train import sparse_grad_embed

    dev = _cuda()
    D, T = 64, 2048
    assert 4 * V > hist._fns()["smem"]  # the global-counter instance
    rng = np.random.default_rng(V)
    toks = torch.from_numpy(np.where(
        rng.random(T) < 0.5, rng.integers(0, 16, T),
        rng.integers(0, V, T)).astype(np.int32))
    e = toks.to(dev)
    kw = dict(nbins=V, block_b=default_block_b(V, L=T))
    offsets, _ = block_offsets(e, **kw)
    assert torch.equal(hist.block_histogram(e, **kw),
                       block_histogram_ref(e, **kw))
    assert torch.equal(cs.placement(e, offsets, **kw),
                       placement_ref(e, offsets, **kw))
    g = rng.integers(-64, 64, (T, D)) if upstream == "integer" \
        else rng.standard_normal((T, D))
    g = torch.from_numpy(g.astype(np.float32))
    grads = []
    for d in (dev, torch.device("cpu")):
        table = torch.zeros((V, D), device=d, requires_grad=True)
        (sparse_grad_embed(table, toks.to(d)) * g.to(d)).sum().backward()
        grads.append(table.grad.cpu())
    if upstream == "integer":
        assert torch.equal(grads[0], grads[1])
        return
    n = torch.bincount(toks.long(), minlength=V)[:, None].double()
    abs_sum = torch.zeros((V, D), dtype=torch.float64).index_add_(
        0, toks.long(), g.abs().double())
    eps = float(np.finfo(np.float32).eps)
    bound = 2 * (n - 1).clamp(min=0) * eps * abs_sum
    assert bool(((grads[0] - grads[1]).abs().double() <= bound).all())
