"""The port's plans and fills against the JAX package's.

A plan made by either package on the same numpy triplets has
bit-identical int32 fields; fills of integer-valued data agree bit for
bit, random float32 fills within the stated tolerance, and the
autograd backward of a fill equals ``jax.grad`` through the reference's.
On the CPU every kernel of the port runs its plain version; the
reference runs ``method="radix"`` on its Pallas kernels in interpret
mode.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.ransparse import dataset
from repro.kernels.assembly_ops import plan_pallas as jax_plan_pallas
from repro.sparse.pattern import plan as jax_plan
from repro_torch.kernels import assembly_ops
from repro_torch.sparse import matlab
from repro_torch.sparse.pattern import (SparsePattern, pattern_from_arrays,
                                        plan, trivial_pattern)

torch.set_num_threads(1)

FIELDS = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")
METHODS = ("fused", "radix")


def _assert_same_structure(mine, ref, fields=FIELDS):
    for f in fields:
        got, want = getattr(mine, f), np.asarray(getattr(ref, f))
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


@functools.lru_cache(maxsize=None)
def _table41(k):
    return dataset(k, scale=0.01)


@pytest.mark.parametrize("method", ("jnp",) + METHODS)
@pytest.mark.parametrize("k", [1, 3])
def test_plan_fields_match_reference(k, method):
    ii, jj, _, siz = _table41(k)
    rows, cols = (ii - 1).astype(np.int32), (jj - 1).astype(np.int32)
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (siz, siz),
                method=method)
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (siz, siz),
                   method=method)
    _assert_same_structure(mine, ref)


@pytest.mark.parametrize("nzmax,slack", [(None, 7), (50, 0), (0, 0)])
def test_capacity_and_padding_match_reference(nzmax, slack):
    rng = np.random.default_rng(9)
    M, N, L = 30, 20, 800
    rows = rng.integers(0, M + 1, L).astype(np.int32)  # row == M: padding
    cols = rng.integers(0, N, L).astype(np.int32)
    vals = rng.integers(-6, 7, L).astype(np.float32)
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (M, N),
                nzmax=nzmax, nzmax_slack=slack, method="radix")
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (M, N),
                   nzmax=nzmax, nzmax_slack=slack, method="radix")
    _assert_same_structure(mine, ref)
    np.testing.assert_array_equal(
        mine.assemble(torch.from_numpy(vals)).data.numpy(),
        np.asarray(ref.assemble(jnp.asarray(vals)).data))


@pytest.mark.parametrize("shape", [(0, 5), (4, 0)])
def test_zero_dim_plan_is_trivial_and_launches_nothing(shape):
    rows = torch.tensor([0, 0, 0], dtype=torch.int32)
    cols = torch.tensor([0, 1, 0], dtype=torch.int32)
    mine = plan(rows, cols, shape)
    ref = jax_plan(jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
                   shape)
    _assert_same_structure(mine, ref)
    np.testing.assert_array_equal(
        mine.assemble(torch.ones(3)).data.numpy(),
        np.asarray(ref.assemble(jnp.ones(3)).data))
    triv = trivial_pattern(3, shape, device="cpu")
    _assert_same_structure(triv, ref)


@pytest.mark.parametrize("method", METHODS)
def test_reference_plan_filled_by_port_equals_reference_fill(method):
    ii, jj, _, siz = _table41(2)
    rows, cols = (ii - 1).astype(np.int32), (jj - 1).astype(np.int32)
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (siz, siz),
                   method=method)
    mine = pattern_from_arrays({f: np.asarray(getattr(ref, f))
                                for f in FIELDS}, ref.shape, device="cpu")
    assert isinstance(mine, SparsePattern) and mine.nzmax == ref.nzmax
    rng = np.random.default_rng(4)
    vi = rng.integers(-8, 9, rows.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(
        mine.assemble(torch.from_numpy(vi)).data.numpy(),
        np.asarray(ref.assemble(jnp.asarray(vi)).data))
    vn = rng.standard_normal(rows.shape[0]).astype(np.float32)
    np.testing.assert_allclose(
        mine.assemble(torch.from_numpy(vn)).data.numpy(),
        np.asarray(ref.assemble(jnp.asarray(vn)).data),
        rtol=0, atol=4 * np.finfo(np.float32).eps * np.abs(vn).sum())


@pytest.mark.parametrize("accum", ["sum", "mean", "first", "last"])
def test_gradient_matches_jax_grad(accum):
    rng = np.random.default_rng(21)
    M, N, L = 12, 9, 200
    rows = rng.integers(0, M + 1, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    vals = rng.standard_normal(L).astype(np.float32)
    w = rng.standard_normal(L).astype(np.float32)
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (M, N),
                   accum=accum, method="fused")
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (M, N),
                accum=accum)
    want = jax.grad(lambda v: jnp.sum(ref.assemble(v).data * w))(
        jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    (got,) = torch.autograd.grad(
        (mine.assemble(v).data * torch.from_numpy(w)).sum(), v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_assemble_batch_matches_reference():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 10, 120).astype(np.int32)
    cols = rng.integers(0, 8, 120).astype(np.int32)
    vb = rng.integers(-5, 6, (4, 120)).astype(np.float32)
    mine = plan(torch.from_numpy(rows), torch.from_numpy(cols), (10, 8))
    ref = jax_plan(jnp.asarray(rows), jnp.asarray(cols), (10, 8))
    got = mine.assemble_batch(torch.from_numpy(vb))
    assert got.data.shape == (4, mine.nzmax)
    np.testing.assert_array_equal(
        got.data.numpy(), np.asarray(ref.assemble_batch(jnp.asarray(vb)).data))


def test_kernel_entry_points_match_reference():
    ii, jj, ss_, siz = _table41(3)
    rows, cols = (ii - 1).astype(np.int32), (jj - 1).astype(np.int32)
    r, c = torch.from_numpy(rows), torch.from_numpy(cols)
    mine = assembly_ops.plan_kernels(r, c, M=siz, N=siz)
    ref = jax_plan_pallas(jnp.asarray(rows), jnp.asarray(cols), M=siz, N=siz)
    _assert_same_structure(mine, ref)
    vals = torch.from_numpy(ss_.astype(np.float32))
    A = assembly_ops.assemble_kernels(r, c, vals, M=siz, N=siz)
    B = assembly_ops.fill_fused(mine, vals)
    S = matlab.fsparse(ii, jj, ss_, (siz, siz), device="cpu")
    for X in (A, B):
        np.testing.assert_array_equal(X.data.numpy(), S.data.numpy())
