"""The port's CUDA kernels and main path on the card.

Every test here is marked ``gpu`` and skips, inside the test, when
``torch.cuda.is_available()`` is false.  The file imports nothing of
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same
inputs: the integer kernels (B1, B2) bit for bit, the fill (B3') bit for
bit on integer-valued data and within ``8 * eps * max_s sum|v|`` on
random values (the plain version's ``index_add_`` adds in another order
on the card).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.oracle import matlab_sparse_oracle
from repro_torch.core.ransparse import dataset
from repro_torch.kernels.radix_sort import ops, radix_sort as rs, ref
from repro_torch.kernels.segment_sum import segment_sum as ss
from repro_torch.kernels.segment_sum.ref import gather_segment_sum_ref
from repro_torch.sparse import matlab
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
