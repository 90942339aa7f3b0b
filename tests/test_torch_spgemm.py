"""The port's two-phase SpGEMM (``repro_torch.sparse.spgemm``) against
the JAX package's ``repro.sparse.spgemm``.

The same numpy triplets plan both operands in both packages (the plans
agree bit for bit, ``test_torch_pattern.py``).  ``product_plan`` must
give the reference's ``sa``, ``sb``, ``perm``, ``slot``, ``indices``,
``indptr`` and ``nnz`` bit for bit, with and without a ``flops_max``
pad and an explicit ``nzmax``.  The refill runs B6's plain version on
the CPU: bit-identical on integer-valued data; on random float32 data
within ``4 * eps * (|A| @ |B|)`` per slot (the reference's scatter and
the port's sorted-run sums add in other orders).  Gradients for both
operands against ``jax.grad``, within ``4 * eps`` of the sums of
``|g * v|`` they are made of.  Error messages are the reference's.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.assembly_ops import multiply_fused as jmultiply_fused
from repro.kernels.segment_sum.ops import (
    gather2_segment_sum_sorted as jgather2)
from repro.sparse import plan as jplan
from repro.sparse import spgemm as jspgemm
from repro.sparse.spgemm import product_plan as jproduct_plan
from repro_torch import kernels
from repro_torch.kernels.assembly_ops import multiply_fused
from repro_torch.kernels.segment_sum.ops import gather2_segment_sum_sorted
from repro_torch.kernels.segment_sum.ref import gather2_segment_sum_ref
from repro_torch.sparse import matlab, ops, spgemm
from repro_torch.sparse.pattern import plan
from repro_torch.sparse.spgemm import (ProductPattern, cached_product_plan,
                                       product_cache_clear,
                                       product_cache_info, product_lookup,
                                       product_pattern_from_arrays,
                                       product_plan, retire_structure)

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
PAT_FIELDS = ("perm", "slot", "indices", "indptr", "nnz")


def _triplets(M, N, L, seed, floats=False):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    vals = (rng.standard_normal(L) if floats
            else rng.integers(-3, 4, L)).astype(np.float32)
    return rows, cols, vals


def _both(M, N, L, seed, floats=False, nzmax=None):
    """(port plan, port CSC, reference plan, reference CSC) of one
    triplet set."""
    rows, cols, vals = _triplets(M, N, L, seed, floats)
    mp = plan(torch.from_numpy(rows), torch.from_numpy(cols), (M, N),
              nzmax=nzmax)
    jp = jplan(jnp.asarray(rows), jnp.asarray(cols), (M, N), nzmax=nzmax)
    return (mp, mp.assemble(torch.from_numpy(vals)), jp,
            jp.assemble(jnp.asarray(vals)))


def _assert_same_product(mine: ProductPattern, ref):
    for k in ("sa", "sb"):
        got = getattr(mine, k)
        assert got.dtype == torch.int32, k
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    for k in PAT_FIELDS:
        np.testing.assert_array_equal(
            getattr(mine.pattern, k).numpy(),
            np.asarray(getattr(ref.pattern, k)), err_msg=k)
    assert (mine.flops, mine.nzmax, mine.shape) == \
        (ref.flops, ref.nzmax, tuple(ref.shape))
    assert (mine.a_capacity, mine.b_capacity, mine.epoch) == \
        (ref.a_capacity, ref.b_capacity, ref.epoch)


@pytest.mark.parametrize("kw", [{}, {"flops_max": 700}, {"nzmax": 150},
                                {"nzmax": 20}, {"flops_max": 650,
                                                "nzmax": 400}])
def test_product_plan_fields_match_reference(kw):
    mpa, A, jpa, JA = _both(20, 15, 80, seed=0)
    mpb, B, jpb, JB = _both(15, 25, 90, seed=1, nzmax=95)
    ref = jproduct_plan(jpa, jpb, **kw)
    for left, right in ((mpa, mpb), (A, B)):  # plans or matrices
        _assert_same_product(product_plan(left, right, **kw), ref)
    got = product_plan(mpa, mpb, **kw)
    C = got.multiply(A.data, B.data)
    JC = ref.multiply(JA.data, JB.data)
    np.testing.assert_array_equal(C.data.numpy(), np.asarray(JC.data))
    np.testing.assert_array_equal(C.indices.numpy(), np.asarray(JC.indices))


@pytest.mark.parametrize("method", ["fused", "radix", "pallas", "jnp"])
def test_every_planning_method_gives_the_same_product(method):
    mpa, _, jpa, _ = _both(30, 30, 150, seed=2)
    ref = jproduct_plan(jpa, jpa)
    _assert_same_product(product_plan(mpa, mpa, method=method), ref)


def test_multiply_and_multiply_fused_random_float_values():
    mpa, A, jpa, JA = _both(20, 15, 80, seed=3, floats=True)
    mpb, B, jpb, JB = _both(15, 25, 90, seed=4, floats=True)
    pp = product_plan(mpa, mpb)
    jpp = jproduct_plan(jpa, jpb)
    want = np.asarray(jpp.multiply(JA.data, JB.data).data)
    want_fused = np.asarray(jmultiply_fused(jpp, JA.data, JB.data,
                                            interpret=True).data)
    mag = np.asarray(jpp.multiply(jnp.abs(JA.data), jnp.abs(JB.data)).data)
    tol = 4 * EPS32 * mag
    # the reference's fused kernel differences a global prefix sum: its
    # error grows with the running sum of |products|, not the slot's own
    tol_fused = 4 * EPS32 * np.cumsum(mag)
    for got in (pp.multiply(A.data, B.data), multiply_fused(pp, A.data,
                                                            B.data)):
        assert got.data.dtype == torch.float32
        assert np.all(np.abs(got.data.numpy() - want) <= tol)
        assert np.all(np.abs(got.data.numpy() - want_fused) <= tol_fused)
    assert kernels.multiply_fused is multiply_fused


def test_gather2_segment_sum_sorted_matches_reference_kernel():
    """B6's plain version and its dtype contract against the reference's
    interpret-mode Pallas ``gather2_masked_cumsum``, on integer-valued
    data (bit for bit), with dropped and padded entries."""
    mpa, A, jpa, JA = _both(20, 15, 80, seed=5)
    mpb, B, jpb, JB = _both(15, 25, 90, seed=6)
    pp = product_plan(mpa, mpb, flops_max=700, nzmax=40)
    jpp = jproduct_plan(jpa, jpb, flops_max=700, nzmax=40)
    want = np.asarray(jgather2(JA.data, JB.data, jpp.sa, jpp.sb,
                               jpp.pattern.slot, num_segments=40,
                               interpret=True))
    got = gather2_segment_sum_sorted(A.data, B.data, pp.sa, pp.sb,
                                     pp.pattern.slot, num_segments=40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, gather2_segment_sum_ref(
        A.data, B.data, pp.sa, pp.sb, pp.pattern.slot, num_segments=40))
    for da, db, want_dtype in ((torch.bfloat16, torch.float32, torch.float32),
                               (torch.float16, torch.float16, torch.float16),
                               (torch.int32, torch.int32, torch.float32)):
        out = gather2_segment_sum_sorted(
            A.data.to(da), B.data.to(db), pp.sa, pp.sb, pp.pattern.slot,
            num_segments=40)
        jout = jgather2(jnp.asarray(A.data.to(torch.float32).numpy())
                        .astype(str(da).split(".")[1]),
                        jnp.asarray(B.data.to(torch.float32).numpy())
                        .astype(str(db).split(".")[1]),
                        jpp.sa, jpp.sb, jpp.pattern.slot, num_segments=40)
        assert out.dtype == want_dtype
        assert str(jout.dtype) == str(want_dtype).split(".")[1]
        np.testing.assert_array_equal(out.to(torch.float64).numpy(),
                                      np.asarray(jout, np.float64))
    # float64 (the reference runs without x64 here): the promoted dtype
    out = gather2_segment_sum_sorted(A.data, B.data.double(), pp.sa, pp.sb,
                                     pp.pattern.slot, num_segments=40)
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(), want)


def test_multiply_gradients_match_jax_grad():
    mpa, A, jpa, JA = _both(20, 15, 80, seed=7, floats=True)
    mpb, B, jpb, JB = _both(15, 25, 90, seed=8, floats=True)
    pp, jpp = product_plan(mpa, mpb), jproduct_plan(jpa, jpb)
    w = np.random.default_rng(9).standard_normal(pp.nzmax).astype(np.float32)
    ga, gb = jax.grad(
        lambda a, b: jnp.sum(jpp.multiply(a, b).data * w), argnums=(0, 1))(
        JA.data, JB.data)
    va = A.data.clone().requires_grad_()
    vb = B.data.clone().requires_grad_()
    (pp.multiply(va, vb).data * torch.from_numpy(w)).sum().backward()
    # each operand gradient sums products g * v over the entries it feeds
    ma, mb = jax.grad(
        lambda a, b: jnp.sum(jpp.multiply(a, b).data * np.abs(w)),
        argnums=(0, 1))(jnp.abs(JA.data), jnp.abs(JB.data))
    for got, want, mag in ((va.grad, ga, ma), (vb.grad, gb, mb)):
        assert np.all(np.abs(got.numpy() - np.asarray(want))
                      <= 4 * EPS32 * np.asarray(mag))


def test_multiply_fused_gradient_equals_multiply_gradient():
    mpa, A, _, _ = _both(12, 10, 40, seed=10, floats=True)
    mpb, B, _, _ = _both(10, 9, 40, seed=11, floats=True)
    pp = product_plan(mpa, mpb)
    grads = []
    for fn in (lambda a, b: pp.multiply(a, b),
               lambda a, b: multiply_fused(pp, a, b)):
        va = A.data.clone().requires_grad_()
        vb = B.data.clone().requires_grad_()
        fn(va, vb).data.square().sum().backward()
        grads.append((va.grad, vb.grad))
    for g1, g2 in zip(*grads):
        assert torch.equal(g1, g2)


def test_shape_errors_match_reference():
    mpa, A, jpa, JA = _both(20, 15, 80, seed=12)
    mpb, B, jpb, JB = _both(15, 25, 90, seed=13)
    pp, jpp = product_plan(mpa, mpb), jproduct_plan(jpa, jpb)

    def msg(fn, *a):
        with pytest.raises(ValueError) as info:
            fn(*a)
        return str(info.value)

    for a, b, ja, jb in ((A.data[:-1], B.data, JA.data[:-1], JB.data),
                         (A.data, B.data[:5], JA.data, JB.data[:5]),
                         (A.data[None], B.data, JA.data[None], JB.data)):
        assert msg(pp.multiply, a, b) == msg(jpp.multiply, ja, jb)
        assert msg(multiply_fused, pp, a, b) == \
            msg(lambda *z: jmultiply_fused(*z, interpret=True), jpp, ja, jb)
    # inner dimensions and the flops_max capacity
    assert msg(product_plan, mpa, mpa) == msg(jproduct_plan, jpa, jpa)
    assert msg(lambda: product_plan(mpa, mpb, flops_max=3)) == \
        msg(lambda: jproduct_plan(jpa, jpb, flops_max=3))


def test_row_compressed_operands_rejected_like_reference():
    from repro.sparse import convert as jconvert
    from repro_torch.sparse import convert

    _, A, _, JA = _both(6, 6, 20, seed=14)
    for bad, jbad in ((convert(A, "csr"), jconvert(JA, "csr")),):
        with pytest.raises(TypeError) as mine:
            product_plan(bad, A)
        with pytest.raises(TypeError) as ref:
            jproduct_plan(jbad, JA)
        assert str(mine.value) == str(ref.value)
    with pytest.raises(TypeError) as mine:
        product_plan(object(), A)
    with pytest.raises(TypeError) as ref:
        jproduct_plan(object(), JA)
    assert str(mine.value) == str(ref.value)


def test_empty_and_degenerate_products_match_reference():
    mpa, A, jpa, JA = _both(8, 5, 10, seed=15)
    empty = torch.zeros(0, dtype=torch.int32)
    z = plan(empty, empty, (5, 7))
    jz = jplan(jnp.zeros(0, jnp.int32), jnp.zeros(0, jnp.int32), (5, 7))
    pp, jpp = product_plan(mpa, z), jproduct_plan(jpa, jz)
    _assert_same_product(pp, jpp)
    C = pp.multiply(A.data, torch.zeros(0))
    assert C.shape == (8, 7) and C.data.shape == (0,)


def test_product_cache_hit_miss_retire_and_epoch():
    product_cache_clear()
    mpa, A, _, _ = _both(20, 15, 80, seed=16)
    mpb, B, _, _ = _both(15, 25, 90, seed=17)
    pp = cached_product_plan(mpa, mpb)
    assert cached_product_plan(A, B) is pp  # same structures: a hit
    info = product_cache_info()
    assert (info["misses"], info["hits"], info["size"]) == (1, 1, 1)
    key, again = product_lookup(mpa, mpb)
    assert again is pp and key[0] == spgemm._structure_key(mpa)
    assert product_cache_info()["hits"] == 2
    # another nzmax is another entry
    cached_product_plan(mpa, mpb, nzmax=pp.nzmax + 5)
    assert product_cache_info()["size"] == 2
    # retiring A's structure drops both products at the next lookup
    retire_structure(spgemm._structure_key(mpa))
    fresh = cached_product_plan(mpa, mpb)
    assert fresh is not pp
    info = product_cache_info()
    assert info["size"] == 1 and info["misses"] == 3
    # epoch: the sum of the operand plans' epochs
    later = dataclasses.replace(mpa, epoch=3)
    assert product_plan(later, dataclasses.replace(mpb, epoch=2)).epoch == 5
    assert product_plan(A, B).epoch == 0
    product_cache_clear()
    assert product_cache_info()["size"] == 0


def test_cache_capacity_from_environment(monkeypatch):
    from repro_torch.sparse.lru import LRUCache

    monkeypatch.setenv("REPRO_PRODUCT_CACHE_SIZE", "3")
    assert LRUCache(16, env="REPRO_PRODUCT_CACHE_SIZE").info()[
        "capacity"] == 3
    assert spgemm._PRODUCT_CACHE.name == jspgemm._PRODUCT_CACHE.name


def test_matmul_and_mtimes_sparse_operands():
    product_cache_clear()
    mpa, A, jpa, JA = _both(20, 15, 80, seed=18)
    mpb, B, jpb, JB = _both(15, 25, 90, seed=19)
    from repro.sparse import mtimes as jmtimes, ops as jops

    C = ops.matmul(A, B)
    JC = jops.matmul(JA, JB)
    for k in ("data", "indices", "indptr", "nnz"):
        np.testing.assert_array_equal(getattr(C, k).numpy(),
                                      np.asarray(getattr(JC, k)), err_msg=k)
    D = matlab.mtimes(ops.transpose(A), A)  # CSR left operand
    JD = jmtimes(jops.transpose(JA), JA)
    np.testing.assert_array_equal(D.to_dense().numpy(),
                                  np.asarray(JD.to_dense()))
    assert product_cache_info()["size"] == 2
    product_cache_clear()


def test_product_pattern_from_arrays_refills_a_reference_plan():
    _, A, jpa, JA = _both(20, 15, 80, seed=20)
    _, B, jpb, JB = _both(15, 25, 90, seed=21)
    jpp = jproduct_plan(jpa, jpb, flops_max=600)
    fields = {k: np.asarray(getattr(jpp.pattern, k)) for k in
              ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")}
    fields.update(sa=np.asarray(jpp.sa), sb=np.asarray(jpp.sb))
    pp = product_pattern_from_arrays(
        fields, jpp.shape, a_capacity=jpp.a_capacity,
        b_capacity=jpp.b_capacity, epoch=jpp.epoch, device="cpu")
    _assert_same_product(pp, jpp)
    np.testing.assert_array_equal(
        pp.multiply(A.data, B.data).data.numpy(),
        np.asarray(jpp.multiply(JA.data, JB.data).data))
