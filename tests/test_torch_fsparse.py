"""The port's main path as a whole against the JAX package and the oracle.

``repro_torch.sparse.fsparse(..., device="cpu")`` runs the plan and the
fill through the kernels' plain versions; the reference runs
``method="fused"`` as XLA sorts and ``method="radix"`` on its Pallas
kernels in interpret mode.  Structure must be bit-identical; the data
sets' values are ones, so the data is bit-identical too.
"""
import functools
import re

import numpy as np
import pytest
import torch

from repro.core.oracle import matlab_sparse_oracle
from repro.core.ransparse import dataset
from repro.launch.mesh import make_data_mesh as jax_mesh
from repro.sparse import matlab as jax_matlab
from repro_torch.kernels.radix_sort import radix_sort as rs
from repro_torch.kernels.segment_sum import segment_sum as ss
from repro_torch.sparse import dispatch, matlab

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


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_fsparse_matches_reference_and_oracle(k, method):
    ii, jj, ss_, siz = _table41(k)
    S = matlab.fsparse(ii, jj, ss_, (siz, siz), method=method, device="cpu")
    R = jax_matlab.fsparse(ii, jj, ss_, (siz, siz), method=method)
    _assert_same_structure(S, R, ("indices", "indptr", "nnz"))
    assert S.data.dtype == torch.float32
    np.testing.assert_array_equal(S.data.numpy(), np.asarray(R.data))
    pr, ir, jc = matlab_sparse_oracle(ii - 1, jj - 1, ss_, siz, siz)
    nnz = int(S.nnz)
    np.testing.assert_array_equal(S.indptr.numpy(), jc)
    np.testing.assert_array_equal(S.indices[:nnz].numpy(), ir)
    np.testing.assert_array_equal(S.data[:nnz].numpy(),
                                  pr.astype(np.float32))


@pytest.mark.parametrize("shape,ii,jj", [
    ((3, 4), [], []), ((0, 0), [], []), ((0, 5), [], []), ((4, 0), [], []),
    (None, [], []),
])
def test_empty_and_zero_dim_match_reference(shape, ii, jj):
    S = matlab.fsparse(ii, jj, [], shape, device="cpu")
    R = jax_matlab.fsparse(ii, jj, [], shape)
    assert S.shape == R.shape
    _assert_same_structure(S, R, ("indices", "indptr", "nnz"))
    assert S.data.shape == R.data.shape


EXPANSIONS = [
    ([1, 2, 3], [1, 1, 2], [1.0, 2.0, 3.0]),             # elementwise
    ([1, 2, 3], [3, 2, 1], 5.0),                         # scalar s
    (np.array([[1], [2]]), np.array([[1, 3]]),
     np.array([[1.0, 2.0], [3.0, 4.0]])),                # outer, full grid
    (2, [1, 2, 3], [1.0, 2.0, 3.0]),                     # scalar i
    (np.array([[1], [3]]), np.array([[2, 3]]), [1.0, 2.0, 3.0, 4.0]),
    (np.array([[1], [3]]), np.array([[2, 3]]), np.array([[1.0], [2.0]])),
    (np.array([[1], [3]]), np.array([[2, 3]]), np.array([[1.0, 2.0]])),
]


@pytest.mark.parametrize("ii,jj,ss_", EXPANSIONS)
def test_index_expansion_matches_reference(ii, jj, ss_):
    for got, want in zip(matlab.expand_indices(ii, jj, ss_),
                         jax_matlab.expand_indices(ii, jj, ss_)):
        np.testing.assert_array_equal(got, want)
    S = matlab.fsparse(ii, jj, ss_, device="cpu")
    R = jax_matlab.fsparse(ii, jj, ss_)
    np.testing.assert_array_equal(S.to_dense().numpy(),
                                  np.asarray(R.to_dense()))


BAD = [
    (([1, 2], [1, 2, 3], [1.0, 1.0]), {}),                      # lengths
    (([1, 2], [1, 2], [1.0, 2.0, 3.0]), {}),                    # s length
    ((np.array([[1], [2]]), np.array([[1, 2]]), [1.0, 2.0, 3.0]), {}),
    (([0, 1], [1, 1], [1.0, 1.0]), {}),                         # bad row
    (([1, 1.5], [1, 1], [1.0, 1.0]), {}),                       # bad row
    (([1, 1], [1, -2], [1.0, 1.0]), {}),                        # bad col
    (([1, 5], [1, 1], [1.0, 1.0]), {"shape": (4, 4)}),          # exceeds
    (([1, 1], [1, 5], [1.0, 1.0]), {"shape": (4, 4)}),          # exceeds
    (([1], [1], [1.0]), {"accum": "median"}),
    (([1], [1], [1.0]), {"format": "coo"}),
    (([1], [1], [1.0]), {"format": "bsr", "block": 0}),
    (([1], [1], [1.0]), {"block": 2}),
]


@pytest.mark.parametrize("args,kw", BAD)
def test_errors_match_reference(args, kw):
    with pytest.raises(ValueError) as ref_err:
        jax_matlab.fsparse(*args, **kw)
    with pytest.raises(ValueError, match=re.escape(str(ref_err.value))):
        matlab.fsparse(*args, device="cpu", **kw)


def test_unknown_method_names_the_available_ones():
    with pytest.raises(ValueError, match="unknown assembly method 'nope'; "
                       r"available: \('fused', 'jnp', 'pallas', 'radix'\)"):
        matlab.fsparse([1], [1], [1.0], method="nope", device="cpu")


@pytest.mark.parametrize("kw", [
    # format="symcsc"|"bsr" are ported (tests/test_torch_symmetric.py),
    # method="sharded" and mesh= too (tests/test_torch_sharded.py)
    pytest.param({"method": "sharded"}, id="kw0-item 14"),
    pytest.param({"mesh": object()}, id="kw3-item 14"),
])
def test_unported_options_raise_naming_their_slice(kw):
    """The options a later slice ported behave as the reference's: a
    sharded assembly (one shard) equals the reference's, and ``mesh=``
    without it raises the reference's error."""
    args = ([1, 2, 2], [1, 2, 2], [1.0, 2.0, 4.0])
    if "mesh" in kw:
        with pytest.raises(ValueError) as ref_err:
            jax_matlab.fsparse(*args, **kw)
        with pytest.raises(ValueError, match=re.escape(str(ref_err.value))):
            matlab.fsparse(*args, device="cpu", **kw)
        return
    S = matlab.fsparse(*args, device="cpu", **kw)
    R = jax_matlab.fsparse(*args, mesh=jax_mesh(1), **kw)
    for f in ("data", "indices", "indptr", "nnz"):
        np.testing.assert_array_equal(getattr(S, f).numpy(),
                                      np.asarray(getattr(R, f)), err_msg=f)


@pytest.mark.parametrize("accum", ["min", "max"])
def test_min_max_need_a_later_kernel(accum):
    """B4 has come: min/max assemble (through its plain version on the
    CPU) and match the reference."""
    rng = np.random.default_rng(11)
    ii, jj = rng.integers(1, 9, 300), rng.integers(1, 7, 300)
    vals = rng.standard_normal(300)
    S = matlab.fsparse(ii, jj, vals, accum=accum, device="cpu")
    R = jax_matlab.fsparse(ii, jj, vals, accum=accum, method="fused")
    np.testing.assert_array_equal(S.data.numpy(), np.asarray(R.data))


@pytest.mark.parametrize("accum", ["sum", "mean", "first", "last"])
def test_accum_modes_match_reference(accum):
    rng = np.random.default_rng(12)
    ii = rng.integers(1, 9, 300)
    jj = rng.integers(1, 7, 300)
    vals = rng.integers(-9, 10, 300).astype(np.float64)
    S = matlab.fsparse(ii, jj, vals, accum=accum, device="cpu")
    R = jax_matlab.fsparse(ii, jj, vals, accum=accum, method="fused")
    np.testing.assert_array_equal(S.data.numpy(), np.asarray(R.data))


def test_find_and_nnz_match_reference():
    ii, jj, ss_ = [3, 2, 3, 1], [1, 2, 1, 2], [7.0, 9.0, 1.0, -2.0]
    S = matlab.fsparse(ii, jj, ss_, device="cpu")
    R = jax_matlab.fsparse(ii, jj, ss_)
    for got, want in zip(matlab.find(S), jax_matlab.find(R)):
        np.testing.assert_array_equal(got, want)
    assert matlab.nnz_of(S) == jax_matlab.nnz_of(R) == 3


def test_default_method_follows_the_device():
    assert dispatch.default_method("cpu") == "fused"
    assert dispatch.default_method("cuda") == "radix"
    assert dispatch.default_method() == "radix"
    assert dispatch.resolve_method("jnp", "cuda") == "jnp"


def test_cpu_path_never_launches_a_kernel():
    before = (rs.digit_block_histogram.launches, rs.digit_placement.launches,
              ss.gather_segment_sum.launches)
    ii, jj, ss_, siz = _table41(3)
    matlab.fsparse(ii, jj, ss_, (siz, siz), method="radix", device="cpu")
    assert (rs.digit_block_histogram.launches, rs.digit_placement.launches,
            ss.gather_segment_sum.launches) == before
