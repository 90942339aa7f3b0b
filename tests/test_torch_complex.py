"""Complex values through the port's float kernels.

The CUDA kernels take float32/float64.  On the card the ops layer sends
a complex operand through them one real part at a time
(``repro_torch.kernels.common.split_complex``): a sum is real-linear,
and a complex product is four real ones.  Here, on the CPU, the split
runs over the kernels' plain versions and is held against the plain
versions on the complex values themselves, and the ops layer is made
to take the card's route (``on_card_complex`` patched to say yes) and
held against its own CPU route and the JAX package.  Integer-valued
data must agree bit for bit, random data within ``c * eps *
sum|terms|`` in each part.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import plan as jplan
from repro_torch import kernels
from repro_torch.kernels import common
from repro_torch.kernels.segment_sum import ops as ss_ops
from repro_torch.kernels.segment_sum.ref import (blocked_cumsum_ref,
                                                 gather2_segment_sum_ref,
                                                 gather_segment_sum_ref)
from repro_torch.kernels.spmv import ops as ell_ops
from repro_torch.kernels.spmv.ref import spmv_ell_ref
from repro_torch.kernels.spmv_sym import ops as sym_ops
from repro_torch.kernels.spmv_sym.ref import bsr_tiles_ref, sym_streams_ref
from repro_torch.sparse import convert, ops, plan, product_plan

torch.set_num_threads(1)

CDTYPES = [torch.complex64, torch.complex128]


def _complex(rng, n, dtype, ints):
    draw = (lambda: rng.integers(-4, 5, n)) if ints else \
        (lambda: rng.standard_normal(n))
    return torch.complex(torch.from_numpy(draw().astype(np.float64)),
                         torch.from_numpy(draw().astype(np.float64))) \
        .to(dtype)


def _agree(got, want, mag, c, dtype, exact):
    """Bit for bit, or each part within c eps of the magnitudes."""
    if exact:
        assert torch.equal(got, want)
        return
    eps = torch.finfo(got.real.dtype).eps
    for part in (torch.real, torch.imag):
        assert bool(torch.all((part(got) - part(want)).abs()
                              <= c * eps * mag + 1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_complex_identities(dtype):
    rng = np.random.default_rng(0)
    cd = torch.complex64 if dtype == torch.float32 else torch.complex128
    a, b = _complex(rng, 50, cd, True), _complex(rng, 50, cd, True)
    r = torch.from_numpy(rng.integers(-4, 5, 50)).to(dtype)
    lin = lambda x: torch.cumsum(x, 0)  # noqa: E731
    bil = lambda x, y: (x * y).cumsum(0)  # noqa: E731
    assert torch.equal(common.split_complex(lin, a), lin(a))
    assert torch.equal(common.split_complex(bil, a, b), bil(a, b))
    assert torch.equal(common.split_complex(bil, a, r), bil(a, r))
    assert torch.equal(common.split_complex(bil, r, b), bil(r, b))
    assert torch.equal(common.split_complex(bil, r, r), bil(r, r))
    pair = common.split_complex(lambda x, y: (x * y, x + 0 * y), a, r)
    assert torch.equal(pair[0], a * r) and torch.equal(pair[1], a)
    # 16-bit parts widen to float32 for the kernels
    h = common.split_complex(lambda x: x, a.to(torch.complex32))
    assert h.dtype == torch.complex64


def _stream(rng, L=3000, nseg=700):
    slot = np.sort(rng.integers(0, nseg, L)).astype(np.int32)
    perm = rng.permutation(L).astype(np.int32)
    return torch.from_numpy(perm), torch.from_numpy(slot), nseg


@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("dtype", CDTYPES)
def test_split_over_the_plain_versions_matches_complex(dtype, ints):
    """B3', B5, B6, B8, B9 and B10's plain versions, split, against the
    same plain versions on complex values."""
    rng = np.random.default_rng(int(ints))
    perm, slot, nseg = _stream(rng)
    L = perm.shape[0]
    v = _complex(rng, L, dtype, ints)
    nz = dict(num_segments=nseg)
    sums = lambda x: gather_segment_sum_ref(x, perm, slot, **nz)  # noqa
    _agree(common.split_complex(sums, v), sums(v),
           gather_segment_sum_ref(v.abs(), perm, slot, **nz), 8, dtype,
           ints)
    _agree(common.split_complex(blocked_cumsum_ref, v),
           blocked_cumsum_ref(v), torch.cumsum(v.abs(), 0), 8, dtype, ints)
    va, vb = _complex(rng, 400, dtype, ints), _complex(rng, 300, dtype, ints)
    sa = torch.from_numpy(rng.integers(0, 400, L).astype(np.int32))
    sb = torch.from_numpy(rng.integers(0, 300, L).astype(np.int32))
    prod = lambda a, b: gather2_segment_sum_ref(  # noqa: E731
        a, b, sa, sb, slot, **nz)
    _agree(common.split_complex(prod, va, vb), prod(va, vb),
           2 * prod(va.abs(), vb.abs()), 16, dtype, ints)
    M, N, K = 60, 50, 5
    cols = torch.from_numpy(rng.integers(0, N + 1, (M, K)).astype(np.int32))
    vals = _complex(rng, M * K, dtype, ints).reshape(M, K)
    x = _complex(rng, N, dtype, ints)
    _agree(common.split_complex(lambda a, b: spmv_ell_ref(cols, a, b),
                                vals, x),
           spmv_ell_ref(cols, vals, x),
           2 * spmv_ell_ref(cols, vals.abs(), x.abs()), 2 * K, dtype, ints)
    rows = torch.from_numpy(np.sort(rng.integers(0, M + 1, L))
                            .astype(np.int32))
    indptr = torch.from_numpy(np.linspace(0, L, M + 1).astype(np.int32))
    xs = _complex(rng, M, dtype, ints)
    up, ct = common.split_complex(
        lambda a, b: sym_streams_ref(rows, a, indptr, b), v, xs)
    up0, ct0 = sym_streams_ref(rows, v, indptr, xs)
    upm, ctm = sym_streams_ref(rows, v.abs(), indptr, xs.abs())
    _agree(up, up0, 2 * upm, 2, dtype, ints)
    _agree(ct, ct0, 2 * ctm, 2 * L, dtype, ints)
    nb, bl = 40, 3
    brows = torch.from_numpy(rng.integers(0, 11, nb).astype(np.int32))
    bcols = torch.from_numpy(rng.integers(0, 10, nb).astype(np.int32))
    data = _complex(rng, nb * bl * bl, dtype, ints).reshape(nb, bl, bl)
    xb = _complex(rng, 10 * bl, dtype, ints)
    tiles = lambda a, b: bsr_tiles_ref(brows, bcols, a, b,  # noqa: E731
                                       Mb=10)
    _agree(common.split_complex(tiles, data, xb), tiles(data, xb),
           2 * tiles(data.abs(), xb.abs()), 2 * bl, dtype, ints)


def _take_card_route(monkeypatch):
    """The ops layer takes the card's route for complex CPU tensors."""
    for mod in (ss_ops, ell_ops, sym_ops):
        monkeypatch.setattr(mod, "on_card_complex",
                            lambda dtype, device: dtype.is_complex)


def _sym_pattern(rng, M=40, L=300):
    """Distinct upper pairs and their mirrors (no duplicates off the
    diagonal, so the float values stay exactly symmetric)."""
    flat = rng.choice(M * M, size=L, replace=False)
    r, c = np.minimum(flat // M, flat % M), np.maximum(flat // M, flat % M)
    _, first = np.unique(r * M + c, return_index=True)
    r, c = r[np.sort(first)], c[np.sort(first)]
    rows = torch.from_numpy(np.concatenate([r, c]).astype(np.int32))
    cols = torch.from_numpy(np.concatenate([c, r]).astype(np.int32))
    return rows, cols, M


@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("dtype", CDTYPES)
def test_card_route_of_fills_spmvs_and_refills_matches_cpu(
        dtype, ints, monkeypatch):
    rng = np.random.default_rng(10 + int(ints))
    rows, cols, M = _sym_pattern(rng)
    half = rows.shape[0] // 2
    v = _complex(rng, half, dtype, ints)
    vals = torch.cat([v, v])  # symmetric values (A == A.T, not Hermitian)
    pat = plan(rows, cols, (M, M))
    x = _complex(rng, M, dtype, ints)

    def run():
        A = pat.assemble(vals)
        out = {"sum": A, "mean": plan(rows, cols, (M, M), accum="mean").assemble(vals),
               "fill_pallas": kernels.fill_pallas(pat, vals)}
        ell_cols, ell_vals, _ = kernels.csc_to_ell(A, max_per_row=M)
        out["ell"] = kernels.spmv(ell_cols, ell_vals, x)
        out["symcsc"] = ops.matmul(convert(A, "symcsc"), x)
        out["bsr"] = ops.matmul(convert(A, "bsr", block=2), x)
        pp = product_plan(A, A)
        out["product"] = pp.multiply(A.data, A.data)
        out["product_real_left"] = pp.multiply(A.data.real.contiguous(),
                                               A.data)
        return out

    cpu = run()
    _take_card_route(monkeypatch)
    card = run()
    scale = float(vals.abs().sum()) * (1 + float(x.abs().max()))
    for k, want in cpu.items():
        got = card[k]
        g, w = (got.data, want.data) if hasattr(got, "data") and not \
            isinstance(got, torch.Tensor) else (got, want)
        assert g.dtype == w.dtype == dtype, k
        if ints:
            assert torch.equal(g, w), k
        else:
            eps = torch.finfo(g.real.dtype).eps
            tol = 64 * eps * scale * (scale if "product" in k else 1)
            assert float((g - w).abs().max()) <= tol, k


@pytest.mark.parametrize("dtype", CDTYPES)
def test_card_route_of_the_fill_matches_the_reference(dtype, monkeypatch):
    """The split fill against the JAX package's complex fill."""
    _take_card_route(monkeypatch)
    rng = np.random.default_rng(7)
    rows, cols, M = _sym_pattern(rng)
    vals = _complex(rng, rows.shape[0], dtype, True)
    got = plan(rows, cols, (M, M)).assemble(vals)
    want = jplan(jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
                 (M, M)).assemble(jnp.asarray(vals.numpy()))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
