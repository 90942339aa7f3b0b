"""The port's ELL SpMV family (``repro_torch.kernels.spmv``) against the
JAX package's ``repro.kernels.spmv``.

``csc_to_ell`` must give the reference's ``cols``/``vals``/``overflow``
bit for bit (it only moves entries).  ``spmv`` runs B8's plain version
on the CPU; it is held against ``spmv_ell_ref`` and the reference's
interpret-mode Pallas ``spmv_ell``: bit for bit on integer-valued data,
within ``4 * eps * (|vals| @ |x[cols]|)`` per row on random float32
data (the sums over a row's ``K`` slots run in other orders).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.spmv.ops import csc_to_ell as jcsc_to_ell
from repro.kernels.spmv.ops import spmv as jspmv
from repro.kernels.spmv.ref import spmv_ell_ref as jspmv_ell_ref
from repro.sparse import plan as jplan
from repro_torch import kernels
from repro_torch.kernels.spmv.ops import csc_to_ell, spmv
from repro_torch.kernels.spmv.ref import spmv_ell_ref

from test_torch_formats import rect_csc, to_port

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _fem_like(M=40, N=30, per_row=5, seed=0, floats=False):
    """A reference CSC with at most ``per_row`` entries a row (some rows
    empty, some at the bound)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(M):
        k = rng.integers(0, per_row + 1)
        rows += [r] * k
        cols += list(rng.choice(N, size=k, replace=False))
    rows = np.array(rows, np.int32)
    cols = np.array(cols, np.int32)
    vals = (rng.standard_normal(rows.size) if floats
            else rng.integers(-4, 5, rows.size)).astype(np.float32)
    pat = jplan(jnp.asarray(rows), jnp.asarray(cols), (M, N),
                nzmax=rows.size + 4)
    return pat.assemble(jnp.asarray(vals))


@pytest.mark.parametrize("K", [1, 3, 5, 8])
def test_csc_to_ell_matches_reference(K):
    A = _fem_like()
    cols, vals, overflow = csc_to_ell(to_port(A), max_per_row=K)
    want = jcsc_to_ell(A, max_per_row=K)
    assert cols.dtype == torch.int32 and cols.shape == (40, K)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want[1]))
    assert overflow.ndim == 0 and overflow.dtype == torch.bool
    assert bool(overflow) == bool(want[2]) == (K < 5)


def test_csc_to_ell_with_duplicates_and_padding():
    A = rect_csc()
    for K in (2, 6):
        got = csc_to_ell(to_port(A), max_per_row=K)
        want = jcsc_to_ell(A, max_per_row=K)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("floats", [False, True])
def test_spmv_matches_reference_and_plain_version(floats):
    A = _fem_like(seed=1, floats=floats)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(30) if floats
         else rng.integers(-3, 4, 30)).astype(np.float32)
    cols, vals, overflow = csc_to_ell(to_port(A), max_per_row=5)
    assert not bool(overflow)
    got = spmv(cols, vals, torch.from_numpy(x)).numpy()
    jc, jv, _ = jcsc_to_ell(A, max_per_row=5)
    want = np.asarray(jspmv(jc, jv, jnp.asarray(x), interpret=True))
    want_ref = np.asarray(jspmv_ell_ref(jc, jv, jnp.asarray(x)))
    plain = spmv_ell_ref(cols, vals, torch.from_numpy(x)).numpy()
    if floats:
        tol = 4 * EPS32 * (np.abs(vals.numpy())
                           * np.abs(np.append(x, 0)[cols.numpy()])).sum(1)
        for other in (want, want_ref, plain):
            assert np.all(np.abs(got - other) <= tol)
    else:
        for other in (want, want_ref, plain):
            np.testing.assert_array_equal(got, other)
    # and the product is A @ x
    dense = np.asarray(A.to_dense()) @ x
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)


def test_spmv_dtypes_and_exports():
    A = _fem_like(seed=3)
    cols, vals, _ = csc_to_ell(to_port(A), max_per_row=5)
    x64 = torch.arange(30, dtype=torch.float64)
    y = spmv(cols, vals, x64)
    assert y.dtype == torch.float64
    torch.testing.assert_close(y, spmv_ell_ref(cols, vals.double(), x64))
    y16 = spmv(cols, vals.to(torch.bfloat16), torch.ones(30,
                                                         dtype=torch.bfloat16))
    assert y16.dtype == torch.bfloat16
    assert kernels.spmv is spmv and kernels.csc_to_ell is csc_to_ell


def test_spmv_empty_rows_and_matrix():
    cols = torch.full((3, 2), 4, dtype=torch.int32)  # all padding
    vals = torch.zeros(3, 2)
    assert torch.equal(spmv(cols, vals, torch.ones(4)), torch.zeros(3))
    assert spmv(torch.zeros((0, 2), dtype=torch.int32), torch.zeros(0, 2),
                torch.ones(4)).shape == (0,)


@pytest.mark.parametrize("name", ["spmv", "spmv_sym"])
def test_kernels_package_names_the_function_not_the_subpackage(name):
    """``repro_torch.kernels.spmv`` and ``.spmv_sym`` are the functions
    (as ``repro.kernels.spmv`` is), whichever way the subpackages were
    imported; the subpackages and their modules import by dotted path
    with ``from`` or ``importlib``."""
    import importlib

    import repro.kernels as jkernels

    ops_mod = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    sub = importlib.import_module(f"repro_torch.kernels.{name}")
    importlib.import_module(f"repro_torch.kernels.{name}.{name}")
    assert getattr(kernels, name) is getattr(ops_mod, name)
    assert callable(getattr(kernels, name))
    assert sub.ops is ops_mod and sub.__name__.endswith(f".{name}")
    assert callable(jkernels.spmv)
    with pytest.raises(AttributeError):
        kernels.no_such_kernel
