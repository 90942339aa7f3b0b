"""repro_torch core pieces against the JAX package: the numpy copies
(oracle, data sets, warnings), the containers and the kernel helpers.

Inputs are made with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

import repro.core.oracle as jax_oracle
import repro.sparse.errors as jax_errors
from repro.core.coo import coo_from_matlab as jax_coo_from_matlab
from repro.core.csc import slot_columns as jax_slot_columns
from repro.core.csc import spmv as jax_spmv
from repro.core.csc import spmv_t as jax_spmv_t
from repro.core.ransparse import DATA_SETS as JAX_DATA_SETS
from repro.core.ransparse import dataset as jax_dataset
from repro.sparse.matlab import fsparse as jax_fsparse
from repro_torch.core import oracle, ransparse
from repro_torch.core.coo import coo_from_matlab
from repro_torch.core.csc import csc_from_arrays, slot_columns, spmv, spmv_t
from repro_torch.kernels.common import cdiv, pad_to, resolve_device, round_up
from repro_torch.sparse import errors

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_copy_matches_reference(seed):
    rng = np.random.default_rng(seed)
    M, N, L = 37, 23, 2000
    ii = rng.integers(0, M + 1, L)          # row == M is padding
    jj = rng.integers(0, N, L)
    ss = rng.standard_normal(L)
    got = oracle.matlab_sparse_oracle(ii, jj, ss, M, N)
    want = jax_oracle.matlab_sparse_oracle(ii, jj, ss, M, N)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_oracle_copy_empty():
    got = oracle.matlab_sparse_oracle([], [], [], 3, 4)
    want = jax_oracle.matlab_sparse_oracle([], [], [], 3, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("scale", [0.01, 0.002])
def test_dataset_copy_matches_reference(k, scale):
    assert ransparse.DATA_SETS == JAX_DATA_SETS
    for g, w in zip(ransparse.dataset(k, seed=3, scale=scale),
                    jax_dataset(k, seed=3, scale=scale)):
        np.testing.assert_array_equal(g, w)


def test_warning_hierarchy_copied():
    for name in ("ReproWarning", "FallbackWarning", "CapacityWarning",
                 "CacheCorruptionWarning", "InvariantViolation"):
        mine, ref = getattr(errors, name), getattr(jax_errors, name)
        assert [c.__name__ for c in mine.__mro__] == \
            [c.__name__ for c in ref.__mro__]
    e = errors.InvariantViolation("perm-permutation", "bad", subject="x")
    r = jax_errors.InvariantViolation("perm-permutation", "bad", subject="x")
    assert str(e) == str(r) and e.invariant == r.invariant


def test_coo_from_matlab_matches_reference():
    rng = np.random.default_rng(5)
    ii = rng.integers(1, 9, 50)
    jj = rng.integers(1, 7, 50)
    ss = rng.standard_normal(50)
    mine = coo_from_matlab(ii, jj, ss, device="cpu")
    ref = jax_coo_from_matlab(ii, jj, ss)
    assert mine.shape == ref.shape and mine.L == 50
    assert mine.rows.dtype == torch.int32 and mine.vals.dtype == torch.float32
    np.testing.assert_array_equal(mine.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_array_equal(mine.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(mine.vals.numpy(), np.asarray(ref.vals))
    np.testing.assert_array_equal(mine.to_dense().numpy(),
                                  np.asarray(ref.to_dense()))


def test_csc_from_arrays_and_plain_ops_match_reference():
    rng = np.random.default_rng(6)
    M, N = 9, 7
    ii = rng.integers(1, M + 1, 40)
    jj = rng.integers(1, N + 1, 40)
    ss = rng.integers(-4, 5, 40).astype(np.float64)
    A = jax_fsparse(ii, jj, ss, (M, N), method="fused")
    fields = {k: np.asarray(getattr(A, k))
              for k in ("data", "indices", "indptr", "nnz")}
    B = csc_from_arrays(fields, A.shape, device="cpu")
    assert B.nzmax == A.nzmax and B.indices.dtype == torch.int32
    np.testing.assert_array_equal(B.to_dense().numpy(),
                                  np.asarray(A.to_dense()))
    np.testing.assert_array_equal(
        slot_columns(B.indptr, B.nzmax).numpy(),
        np.asarray(jax_slot_columns(A.indptr, A.nzmax)))
    x = rng.integers(-3, 4, N).astype(np.float32)
    y = rng.integers(-3, 4, M).astype(np.float32)
    np.testing.assert_array_equal(spmv(B, torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_spmv(A, x)))
    np.testing.assert_array_equal(spmv_t(B, torch.from_numpy(y)).numpy(),
                                  np.asarray(jax_spmv_t(A, y)))


def test_integer_helpers():
    assert [cdiv(a, 4) for a in (0, 1, 4, 5)] == [0, 1, 1, 2]
    assert [round_up(a, 4) for a in (0, 1, 4, 5)] == [0, 4, 4, 8]
    x = torch.arange(3)
    assert pad_to(x, 3, -1) is x
    assert pad_to(x, 5, -1).tolist() == [0, 1, 2, -1, -1]


def test_host_entry_points_default_to_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coo_from_matlab([1, 2], [1, 1], [1.0, 2.0])
