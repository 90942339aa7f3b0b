"""The port's operator surface (``repro_torch.sparse.ops``) against the
JAX package's ``repro.sparse.ops``.

Each reference matrix is handed to the port unchanged
(``test_torch_formats.to_port``); the same numpy vectors go through
both packages.  On the CPU the port's SymCSC and BSR spmv run the plain
versions of B9 and B10; the reference runs its jnp oracles, and its
interpret-mode Pallas kernels where a test says so.

Tolerances: on integer-valued data every product and sum is exact, so
results must be bit-identical.  On random float32 data the two packages
add in other orders: each output is held within ``8 * eps * (|A| @
|x|)``, the bound of any summation order over the few terms a row has.
Gradients against ``jax.grad`` are held the same way.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.csc import CSC as JCSC
from repro.kernels.spmv_sym import spmv_bsr as jspmv_bsr
from repro.kernels.spmv_sym import spmv_sym as jspmv_sym
from repro.sparse import convert as jconvert, ops as jops
from repro.sparse.formats import BSR as JBSR, SymCSC as JSymCSC
from repro_torch.core.csc import CSC
from repro_torch.kernels.spmv_sym.ops import spmv_bsr, spmv_sym
from repro_torch.sparse import ops
from repro_torch.sparse.formats import BSR, CSR, SymCSC

from test_torch_formats import assert_same, rect_csc, sym_csc, to_port

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
FORMATS = ("csc", "csr", "coo", "symcsc", "bsr")


def _matrix(fmt, *, floats=False, seed=0):
    """A reference matrix in ``fmt`` (symmetric, 12 x 12, block 2)."""
    A, (rows, cols, vals) = sym_csc(seed=seed)
    if floats:
        # symmetric random values: one value per unordered pair
        rng = np.random.default_rng(seed + 100)
        lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
        table = rng.standard_normal((12, 12)).astype(np.float32)
        vals = table[lo, hi]
        from repro.sparse import plan as jplan

        A = jplan(jnp.asarray(rows), jnp.asarray(cols), A.shape).assemble(
            jnp.asarray(vals))
    kw = {"block": 2} if fmt == "bsr" else {}
    return A, jconvert(A, fmt, **kw)


def _bound(A, x):
    """``8 eps |A| @ |x|`` per output (x a vector or a matrix)."""
    return 8 * EPS32 * (np.abs(np.asarray(A.to_dense()))
                        @ np.abs(np.asarray(x)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_matmul_integer_data_bit_identical(fmt):
    _, X = _matrix(fmt)
    rng = np.random.default_rng(1)
    x = rng.integers(-3, 4, 12).astype(np.float32)
    Xm = rng.integers(-3, 4, (12, 3)).astype(np.float32)
    P = to_port(X)
    np.testing.assert_array_equal(
        ops.matmul(P, torch.from_numpy(x)).numpy(),
        np.asarray(jops.matmul(X, jnp.asarray(x))))
    np.testing.assert_array_equal(
        ops.matmul(P, torch.from_numpy(Xm)).numpy(),
        np.asarray(jops.matmul(X, jnp.asarray(Xm))))


@pytest.mark.parametrize("fmt", FORMATS)
def test_matmul_random_float_within_bound(fmt):
    A, X = _matrix(fmt, floats=True, seed=3)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(12).astype(np.float32)
    Xm = rng.standard_normal((12, 4)).astype(np.float32)
    P = to_port(X)
    for v in (x, Xm):
        got = ops.matmul(P, torch.from_numpy(v)).numpy()
        want = np.asarray(jops.matmul(X, jnp.asarray(v)))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.all(np.abs(got - want) <= _bound(A, v))


def test_rectangular_matmul_over_compressed_formats():
    A = rect_csc()  # 12 x 8 with padding and duplicates
    x = np.random.default_rng(4).integers(-3, 4, 8).astype(np.float32)
    for fmt in ("csc", "csr", "coo"):
        X = jconvert(A, fmt)
        np.testing.assert_array_equal(
            ops.matmul(to_port(X), torch.from_numpy(x)).numpy(),
            np.asarray(jops.matmul(X, jnp.asarray(x))), err_msg=fmt)
    with pytest.raises(ValueError, match="vector or matrix"):
        ops.matmul(to_port(A), torch.zeros(2, 2, 2))


def test_symcsc_and_bsr_spmv_match_the_reference_kernels():
    """The port's spmv_sym/spmv_bsr (plain versions of B9/B10 here)
    against the reference's interpret-mode Pallas kernels and its
    oracles, bit for bit on integer-valued data."""
    A, S = _matrix("symcsc")
    x = np.random.default_rng(5).integers(-3, 4, 12).astype(np.float32)
    args = [np.array(getattr(S, k)) for k in
            ("diag", "data", "indices", "indptr")]
    want = np.asarray(jspmv_sym(*map(jnp.asarray, args), jnp.asarray(x),
                                interpret=True))
    got = spmv_sym(*map(torch.from_numpy, args), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    B = jconvert(A, "bsr", block=2)
    bargs = [np.array(getattr(B, k)) for k in ("data", "indices",
                                                 "indptr")]
    want = np.asarray(jspmv_bsr(*map(jnp.asarray, bargs), jnp.asarray(x),
                                shape=B.shape, block=2, interpret=True))
    got = spmv_bsr(*map(torch.from_numpy, bargs), torch.from_numpy(x),
                   shape=B.shape, block=2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_transpose_matches_reference(fmt):
    _, X = _matrix(fmt)
    T = ops.transpose(to_port(X))
    assert_same(T, jops.transpose(X))
    if fmt == "symcsc":
        P = to_port(X)
        assert ops.transpose(P) is P
    if fmt == "bsr":
        TT = ops.transpose(T)
        assert_same(TT, jops.transpose(jops.transpose(X)))


def test_transpose_rectangular_and_reinterpretations():
    A = rect_csc()
    P = to_port(A)
    T = ops.transpose(P)
    assert isinstance(T, CSR) and T.shape == (8, 12)
    assert T.data is P.data and T.indices is P.indices
    assert isinstance(ops.transpose(T), CSC)
    assert_same(T, jops.transpose(A))
    assert_same(ops.transpose(to_port(jconvert(A, "coo"))),
                jops.transpose(jconvert(A, "coo")))
    B = jconvert(A, "bsr", block=4)
    assert_same(ops.transpose(to_port(B)), jops.transpose(B))


@pytest.mark.parametrize("fa,fb", [("csc", "csc"), ("csc", "csr"),
                                   ("csr", "coo"), ("coo", "bsr"),
                                   ("bsr", "csc"), ("symcsc", "csc")])
def test_add_matches_reference(fa, fb):
    _, X = _matrix(fa)
    _, Y = _matrix(fb, seed=1)
    assert_same(ops.add(to_port(X), to_port(Y)), jops.add(X, Y))


def test_add_scale_diagonal_to_dense():
    A, _ = _matrix("csc")
    P = to_port(A)
    with pytest.raises(ValueError) as mine:
        ops.add(to_port(rect_csc()), P)
    with pytest.raises(ValueError) as ref:
        jops.add(rect_csc(), A)
    assert str(mine.value) == str(ref.value)
    for fmt in FORMATS:
        _, X = _matrix(fmt)
        assert_same(ops.scale(to_port(X), 2.5), jops.scale(X, 2.5))
        np.testing.assert_array_equal(ops.diagonal(to_port(X)).numpy(),
                                      np.asarray(jops.diagonal(X)))
        np.testing.assert_array_equal(ops.to_dense(to_port(X)).numpy(),
                                      np.asarray(jops.to_dense(X)))
    R = rect_csc()
    np.testing.assert_array_equal(ops.diagonal(to_port(R)).numpy(),
                                  np.asarray(jops.diagonal(R)))


def test_scatter_rows_forward_and_backward_match_reference():
    slot = np.array([3, 0, 9, 1], np.int32)  # 9 >= 5: dropped
    rows = np.random.default_rng(6).standard_normal((4, 2)) \
        .astype(np.float32)
    w = np.random.default_rng(7).standard_normal((5, 2)).astype(np.float32)
    want = jops.scatter_rows(jnp.asarray(slot), jnp.asarray(rows),
                             num_slots=5)
    r = torch.from_numpy(rows).requires_grad_()
    got = ops.scatter_rows(torch.from_numpy(slot), r, num_slots=5)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(w)).sum().backward()
    g = jax.grad(lambda rr: jnp.sum(jops.scatter_rows(
        jnp.asarray(slot), rr, num_slots=5) * w))(jnp.asarray(rows))
    np.testing.assert_array_equal(r.grad.numpy(), np.asarray(g))


def _port_grads(P, x, w, fields):
    leaves = {k: getattr(P, k).clone().requires_grad_() for k in fields}
    Q = dataclasses.replace(P, **leaves)
    xt = torch.from_numpy(x).requires_grad_()
    (ops.matmul(Q, xt) * torch.from_numpy(w)).sum().backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}, xt.grad.numpy()


@pytest.mark.parametrize("fmt,fields", [
    ("csc", ("data",)), ("symcsc", ("diag", "data")), ("bsr", ("data",)),
])
def test_matmul_gradients_match_jax_grad(fmt, fields):
    """d/d(values) and d/dx of ``sum(w * (A @ x))`` against jax.grad of
    the reference's custom_vjp (CSC, SymCSC, BSR)."""
    A, X = _matrix(fmt, floats=True, seed=8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(12).astype(np.float32)
    w = rng.standard_normal(12).astype(np.float32)
    cls = {"csc": JCSC, "symcsc": JSymCSC, "bsr": JBSR}[fmt]

    def loss(vals, xx, ww):
        Y = dataclasses.replace(X, **dict(zip(fields, vals)))
        return jnp.sum(jops.matmul(Y, xx) * ww)

    assert isinstance(X, cls)
    vals = tuple(getattr(X, k) for k in fields)
    g_vals, g_x = jax.grad(loss, argnums=(0, 1))(vals, jnp.asarray(x), w)
    # the same gradients of |A|, |x|, |w|: the sums of |terms|
    m_vals = jax.grad(loss)(tuple(jnp.abs(v) for v in vals),
                            jnp.abs(jnp.asarray(x)), np.abs(w))
    got_vals, got_x = _port_grads(to_port(X), x, w, fields)
    # g_x = A^T w: the bound of A^T's rows (A is symmetric)
    assert np.all(np.abs(got_x - np.asarray(g_x)) <= _bound(A, w))
    for k, want, mag in zip(fields, g_vals, m_vals):
        # each value gradient sums one or two products of x and w
        tol = 4 * EPS32 * np.asarray(mag)
        assert np.all(np.abs(got_vals[k] - np.asarray(want)) <= tol), k


def test_symcsc_backward_reuses_the_forward():
    """The symmetric spmv is self-transpose: its backward for x is one
    more forward through the same operator (the reference's rule)."""
    _, S = _matrix("symcsc", floats=True, seed=10)
    P = to_port(S)
    x = torch.randn(12, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    g = torch.randn(12, generator=torch.Generator().manual_seed(1))
    ops.matmul(P, x).backward(g)
    torch.testing.assert_close(x.grad, ops.matmul(P, g), rtol=0, atol=0)


def test_typeerror_inside_spgemm_surfaces():
    """A TypeError raised inside the SpGEMM path (an unconvertible left
    operand) surfaces with the reference's message."""
    A, _ = _matrix("csc")
    with pytest.raises(TypeError) as mine:
        ops.matmul(np.eye(12), to_port(A))
    with pytest.raises(TypeError) as ref:
        jops.matmul(np.eye(12), A)
    assert str(mine.value) == str(ref.value)
    assert "no conversion path" in str(mine.value)


def test_dispatch_errors_match_reference():
    A, _ = _matrix("csc")
    with pytest.raises(TypeError) as mine:
        ops._dispatch("frobnicate", to_port(A))
    with pytest.raises(TypeError) as ref:
        jops._dispatch("frobnicate", A)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(TypeError, match="not a registered sparse format"):
        ops.matmul(object(), torch.ones(3))


def test_spmv_impl_resolves_through_the_hub():
    _, S = _matrix("symcsc")
    fn, A = ops.spmv_impl(to_port(S))
    assert fn is ops._symcsc_spmv and isinstance(A, SymCSC)
    _, B = _matrix("bsr")
    fn, A = ops.spmv_impl(to_port(B))
    assert isinstance(A, BSR)
    x = torch.ones(12)
    torch.testing.assert_close(fn(A, x), ops.matmul(to_port(B), x))
