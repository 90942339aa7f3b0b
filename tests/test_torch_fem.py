"""The third path end to end in both packages: the FEM workload of
``examples/fem_poisson.py`` (P1 assembly, SpMV in every format, CG) and
``examples/fem_multigrid.py`` (the Galerkin product ``P' A P`` on the
two-phase SpGEMM), at small sizes.

The same numpy triplets go through the JAX package and the port (on the
CPU, where every kernel runs its plain version).  All values here are
dyadic (stiffness entries in halves, interpolation weights 1, 1/2,
1/4), so every product and sum is exact in float32: matrices, SpMVs and
Galerkin products must be bit-identical between the packages and equal
to scipy's float64 products.  CG runs the example's iteration; its
iterates agree between the packages within ``1e-5`` (float32 CG in two
summation orders) and both meet the example's error bound against
``sin(pi x) sin(pi y)``.  The data builders and checks of
``chip_smoke.py`` are held here against the examples' own.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.sparse import cached_product_plan as jcached_product_plan
from repro.sparse import convert as jconvert, ops as jops, plan as jplan
from repro.sparse import product_cache_info as jproduct_cache_info
from repro_torch import kernels
from repro_torch.sparse import (cached_product_plan, convert, ops, plan,
                                product_cache_clear, product_cache_info)

from test_torch_formats import assert_same

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke.py at the repo root
import chip_smoke  # noqa: E402

sp = pytest.importorskip("scipy.sparse")
torch.set_num_threads(1)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both_csc(rows, cols, vals, shape):
    """The port's and the reference's CSC of one triplet set."""
    mine = plan(torch.from_numpy(rows.astype(np.int32)),
                torch.from_numpy(cols.astype(np.int32)), shape).assemble(
        torch.from_numpy(vals.astype(np.float32)))
    ref = jplan(jnp.asarray(rows.astype(np.int32)),
                jnp.asarray(cols.astype(np.int32)), shape).assemble(
        jnp.asarray(vals.astype(np.float32)))
    assert_same(mine, ref)
    return mine, ref


@pytest.mark.parametrize("n", [4, 21])
def test_vectorised_p1_triplets_match_the_example(n):
    rows, cols, vals, nv = _example("fem_poisson").p1_triangle_triplets(n)
    r, c, v, nv2 = chip_smoke.p1_triplets(n)
    assert nv == nv2
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(c, cols)
    np.testing.assert_array_equal(v, vals)


def _jax_cg(A, b, iters):
    """fem_poisson.py's CG, on the reference's operator surface."""
    x = jnp.zeros_like(b)
    r = b - jops.matmul(A, x)
    p, rs = r, jnp.dot(r, r)
    for _ in range(iters):
        Ap = jops.matmul(A, p)
        alpha = rs / jnp.maximum(jnp.dot(p, Ap), 1e-30)
        x, r = x + alpha * p, r - alpha * Ap
        rs_new = jnp.dot(r, r)
        p = r + (rs_new / jnp.maximum(rs, 1e-30)) * p
        rs = rs_new
    return x


def test_fem_poisson_slice_matches_reference():
    n, iters = 21, 60
    rows, cols, vals, nv, f, u_exact = chip_smoke.fem_system(n)
    A, JA = _both_csc(rows, cols, vals, (nv, nv))
    x = np.random.default_rng(0).integers(-3, 4, nv).astype(np.float32)
    want = np.asarray(jops.matmul(JA, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    # the four operators of chip_smoke: CSC, ELL (B8), SymCSC (B9), BSR
    # (B10); exact on these values, so bit-identical to the reference
    cols_e, vals_e, overflow = kernels.csc_to_ell(A, max_per_row=7)
    assert not bool(overflow)
    S, B = convert(A, "symcsc"), convert(A, "bsr", block=2)
    assert_same(S, jconvert(JA, "symcsc"))
    assert_same(B, jconvert(JA, "bsr", block=2))
    for y in (ops.matmul(A, xt), kernels.spmv(cols_e, vals_e, xt),
              ops.matmul(S, xt), ops.matmul(B, xt)):
        np.testing.assert_array_equal(y.numpy(), want)
    # CG on the B8 and the B9 operator, against the reference's CG on CSC
    u_ref = np.asarray(_jax_cg(JA, jnp.asarray(f), iters))
    bound = 10.0 / n ** 2 + 5e-2  # fem_poisson.py's
    for op in (lambda v: kernels.spmv(cols_e, vals_e, v),
               lambda v: ops.matmul(S, v)):
        u, res = chip_smoke.cg(op, torch.from_numpy(f), iters)
        assert np.abs(u.numpy() - u_ref).max() <= 1e-5
        assert np.abs(u.numpy() - u_exact).max() < bound
        assert float(res) < 1e-5


@pytest.mark.parametrize("scale", [1.0, 1.03])
def test_cg_random_check_holds_cg_against_float64(scale):
    """chip_smoke's CG check on a seeded random right-hand side: the
    port's ELL and SymCSC operators and the reference's CSC operator
    each stay within ``CG_RTOL`` of float64 CG's relative residual
    after 50 iterations (which still leave it near 1e-3 here), and an
    operator 3% off in scale is refused."""
    n, iters = 41, 50
    rows, cols, vals, nv, _, _ = chip_smoke.fem_system(n)
    A, JA = _both_csc(rows, cols, vals, (nv, nv))
    Asp = sp.csc_matrix((vals.astype(np.float64), (rows, cols)),
                        shape=(nv, nv))
    b = np.random.default_rng(0).standard_normal(nv).astype(np.float32)
    cols_e, vals_e, _ = kernels.csc_to_ell(A, max_per_row=7)
    S = convert(A, "symcsc")
    ops_cg = {"ell": lambda v: scale * kernels.spmv(cols_e, vals_e, v),
              "symcsc": lambda v: scale * ops.matmul(S, v)}
    cpu = torch.device("cpu")
    if scale != 1.0:
        with pytest.raises(SystemExit):
            chip_smoke.cg_random_check(ops_cg, Asp, b, iters, cpu)
        return
    res = chip_smoke.cg_random_check(ops_cg, Asp, b, iters, cpu)
    assert 1e-4 < res["float64"] < 1e-1
    u_ref = np.asarray(_jax_cg(JA, jnp.asarray(b), iters), np.float64)
    rel_ref = np.linalg.norm(b - Asp @ u_ref) / np.linalg.norm(b)
    assert abs(rel_ref - res["float64"]) <= (
        chip_smoke.CG_RTOL * res["float64"] + chip_smoke.CG_ATOL)


def _galerkin(P, A, mod):
    """P' A P through ops.matmul in either package (``mod`` = ops)."""
    return mod.matmul(mod.matmul(mod.transpose(P), A), P)


def test_fem_multigrid_1d_hierarchy_matches_reference():
    mg = _example("fem_multigrid")
    n = 31
    n_c = (n - 1) // 2
    ra, ca, va = mg.poisson_triplets(n)
    rp, cp, vp, _ = mg.prolongation_triplets(n)
    A, JA = _both_csc(ra, ca, va, (n, n))
    P, JP = _both_csc(rp, cp, vp, (n, n_c))
    product_cache_clear()
    Ac = _galerkin(P, A, ops)
    JAc = _galerkin(JP, JA, jops)
    assert_same(Ac, JAc)
    dense = P.to_dense().T @ A.to_dense() @ P.to_dense()
    torch.testing.assert_close(Ac.to_dense(), dense, rtol=0, atol=0)
    # Galerkin coarsening of the 1-D stencil is the coarse stencil
    h_c = 2.0 / (n + 1)
    np.testing.assert_allclose(torch.diagonal(Ac.to_dense()).numpy(),
                               np.full(n_c, 2.0 / h_c), rtol=1e-6)
    # the coefficient sweep refills through the cached product plans
    misses = product_cache_info()["misses"]
    pat_A = plan(torch.from_numpy(ra), torch.from_numpy(ca), (n, n))
    for kappa in (0.5, 4.0):
        Ak = pat_A.assemble(torch.from_numpy(kappa * va.astype(np.float32)))
        torch.testing.assert_close(_galerkin(P, Ak, ops).data,
                                   kappa * Ac.data, rtol=0, atol=0)
    assert product_cache_info()["misses"] == misses == 2
    pp = cached_product_plan(convert(ops.transpose(P), "csc"), A)
    jpp = jcached_product_plan(jconvert(jops.transpose(JP), "csc"), JA)
    assert pp.flops == jpp.flops and pp.nzmax == jpp.nzmax
    assert jproduct_cache_info()["size"] >= 1


def test_fem_multigrid_2d_galerkin_matches_reference_and_checks():
    """The 2-D P1 matrix and chip_smoke's bilinear prolongation (a
    parent past the edge left out at n = 21): P' A P bit-identical in
    both packages, and chip_smoke's own structure (numpy expansion +
    oracle) and value (scipy) checks pass on it."""
    n = 21
    rows, cols, vals, nv, _, _ = chip_smoke.fem_system(n)
    pr, pc, pv, pshape = chip_smoke.bilinear_prolongation(n)
    assert pshape == (nv, (n // 2 + 1) ** 2)
    A, JA = _both_csc(rows, cols, vals, (nv, nv))
    P, JP = _both_csc(pr, pc, pv, pshape)
    # every fine vertex's weights sum to 1 away from the far edge
    assert np.allclose(P.to_dense().sum(1).numpy()[:n], 1.0)
    product_cache_clear()
    PtA = ops.matmul(ops.transpose(P), A)
    Ac = ops.matmul(PtA, P)
    assert_same(Ac, _galerkin(JP, JA, jops))
    irA, jcA = A.indices[:int(A.nnz)].numpy(), A.indptr.numpy()
    irP, jcP = P.indices[:int(P.nnz)].numpy(), P.indptr.numpy()
    Pt = convert(ops.transpose(P), "csc")
    irT, jcT = Pt.indices[:int(Pt.nnz)].numpy(), Pt.indptr.numpy()
    ir1, jc1 = chip_smoke.product_structure(irT, jcT, irA, jcA, pshape[1], nv)
    np.testing.assert_array_equal(PtA.indices.numpy(), ir1)
    np.testing.assert_array_equal(PtA.indptr.numpy(), jc1)
    ir2, jc2 = chip_smoke.product_structure(ir1, jc1, irP, jcP, pshape[1],
                                            pshape[1])
    np.testing.assert_array_equal(Ac.indices.numpy(), ir2)
    np.testing.assert_array_equal(Ac.indptr.numpy(), jc2)
    Asp = sp.csc_matrix((A.data[:int(A.nnz)].double().numpy(), irA, jcA),
                        shape=(nv, nv))
    Psp = sp.csc_matrix((P.data[:int(P.nnz)].double().numpy(), irP, jcP),
                        shape=pshape)
    want = chip_smoke.values_at(Psp.T @ Asp @ Psp, ir2, jc2)
    np.testing.assert_array_equal(Ac.data.double().numpy(), want)


def test_jax_cg_helper_matches_the_example_scan():
    """The unrolled reference CG above is the example's scan."""
    n = 6
    rows, cols, vals, nv, f, _ = chip_smoke.fem_system(n)
    _, JA = _both_csc(rows, cols, vals, (nv, nv))
    b = jnp.asarray(f)

    def body(carry, _):
        x, r, p, rs = carry
        Ap = jops.matmul(JA, p)
        alpha = rs / jnp.maximum(jnp.dot(p, Ap), 1e-30)
        x, r = x + alpha * p, r - alpha * Ap
        rs_new = jnp.dot(r, r)
        return (x, r, r + (rs_new / jnp.maximum(rs, 1e-30)) * p, rs_new), 0

    r0 = b - jops.matmul(JA, jnp.zeros_like(b))
    (x, _, _, _), _ = jax.lax.scan(body, (jnp.zeros_like(b), r0, r0,
                                          jnp.dot(r0, r0)), None, length=8)
    np.testing.assert_allclose(np.asarray(_jax_cg(JA, b, 8)), np.asarray(x),
                               rtol=0, atol=1e-7)
