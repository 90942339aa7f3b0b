"""The port's format zoo and registry against the JAX package's.

The same numpy triplets are assembled by the reference; each reference
matrix is handed to the port unchanged (``csc_from_arrays``,
``formats.from_arrays``), and every registered conversion runs in both
packages.  Integer structure (indices, indptr, nnz, the COO index
vectors) must be bit-identical; the values are integer-valued, so the
moves and the duplicate sums of the re-plans are exact and the values
must be bit-identical too.  Error messages must be the reference's
word for word.  ``to_port`` and ``assert_same`` are shared with the
other slice-3 test files.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.launch.mesh import make_data_mesh as jax_mesh
from repro.sparse import convert as jconvert, plan as jplan
from repro.sparse import formats as jformats
from repro.sparse.matlab import nnz_of as jnnz_of
from repro_torch.core.coo import COO
from repro_torch.core.csc import CSC, csc_from_arrays
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.sparse import formats, matlab
from repro_torch.sparse.formats import (BSR, CSR, SymCSC, convert,
                                        format_of, from_arrays)
from repro_torch.sparse.sharded import ShardedCSC

torch.set_num_threads(1)

_FIELDS = {
    "coo": ("rows", "cols", "vals"),
    "csc": ("data", "indices", "indptr", "nnz"),
    "csr": ("data", "indices", "indptr", "nnz"),
    "symcsc": ("diag", "data", "indices", "indptr", "nnz"),
    "bsr": ("data", "indices", "indptr", "nnz"),
    "sharded": ("data", "indices", "indptr", "nnz"),
}
_VALUES = ("vals", "data", "diag")


def to_port(X):
    """A reference matrix of any registered format, as the port's (CPU)."""
    fmt = jformats.format_of(X)
    arrays = {k: np.asarray(getattr(X, k)) for k in _FIELDS[fmt]}
    if fmt == "coo":
        return COO(rows=torch.from_numpy(arrays["rows"].astype(np.int32)),
                   cols=torch.from_numpy(arrays["cols"].astype(np.int32)),
                   vals=torch.from_numpy(np.array(arrays["vals"])),
                   shape=tuple(X.shape))
    if fmt == "csc":
        return csc_from_arrays(arrays, X.shape, device="cpu")
    if fmt == "sharded":
        return ShardedCSC(
            data=torch.from_numpy(np.array(arrays["data"])),
            **{k: torch.from_numpy(arrays[k].astype(np.int32))
               for k in ("indices", "indptr", "nnz")},
            shape=tuple(X.shape),
            mesh=make_data_mesh(arrays["data"].shape[0], device="cpu"))
    return from_arrays(fmt, arrays, X.shape, block=getattr(X, "block", 1),
                       device="cpu")


def assert_same(mine, ref, *, rtol=0.0, atol=0.0):
    """Same format, shape and block; integer fields bit-identical, value
    fields within ``rtol``/``atol`` (bit-identical by default)."""
    fmt = jformats.format_of(ref)
    assert format_of(mine) == fmt
    assert tuple(mine.shape) == tuple(ref.shape)
    if fmt == "bsr":  # a ShardedCSC's ``block`` is a method
        assert mine.block == ref.block
    for k in _FIELDS[fmt]:
        got = getattr(mine, k).detach().cpu().numpy()
        want = np.asarray(getattr(ref, k))
        assert got.shape == want.shape, k
        if k in _VALUES:
            if rtol == atol == 0.0:
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                           err_msg=k)
        else:
            assert got.dtype == np.int32, k
            np.testing.assert_array_equal(got, want, err_msg=k)


def sym_csc(seed=0, M=12, L=50, nzmax_slack=0):
    """A reference CSC with symmetric structure and integer values
    (some diagonal entries missing), from symmetrised triplets."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, M, L)
    c = rng.integers(0, M, L)
    keep = r != c
    r, c = r[keep], c[keep]
    v = rng.integers(-4, 5, r.shape[0]).astype(np.float32)
    d = np.arange(0, M, 2)  # every other diagonal entry
    rows = np.concatenate([r, c, d]).astype(np.int32)
    cols = np.concatenate([c, r, d]).astype(np.int32)
    vals = np.concatenate([v, v, np.full(d.size, 3.0, np.float32)])
    pat = jplan(jnp.asarray(rows), jnp.asarray(cols), (M, M),
                nzmax=rows.size + nzmax_slack)
    return pat.assemble(jnp.asarray(vals)), (rows, cols, vals)


def rect_csc(seed=1, M=12, N=8, L=40):
    """A reference CSC of integer values with duplicates and padding."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    rows[::9] = M  # padding sentinels
    vals = rng.integers(-4, 5, L).astype(np.float32)
    pat = jplan(jnp.asarray(rows), jnp.asarray(cols), (M, N), nzmax=L + 3)
    return pat.assemble(jnp.asarray(vals))


def _sources(block=2):
    """Reference matrices of every format, symmetric and aligned to
    ``block`` so every conversion is defined."""
    A, _ = sym_csc()
    return {"csc": A, "coo": jconvert(A, "coo"), "csr": jconvert(A, "csr"),
            "symcsc": jconvert(A, "symcsc"),
            "bsr": jconvert(A, "bsr", block=block),
            "sharded": jconvert(A, "sharded", mesh=jax_mesh(1))}


CONVERSIONS = sorted((src.__name__, tgt)
                     for (src, tgt) in formats._CONVERTERS)


def test_registry_matches_the_reference():
    mine = {(s.__name__, t) for (s, t) in formats._CONVERTERS}
    ref = {(s.__name__, t) for (s, t) in jformats._CONVERTERS}
    assert mine == ref
    assert sorted(formats.FORMATS) == sorted(jformats.FORMATS)


@pytest.mark.parametrize("src,target", CONVERSIONS,
                         ids=[f"{s}-{t}" for s, t in CONVERSIONS])
def test_every_registered_conversion_matches_reference(src, target):
    name = {"COO": "coo", "CSC": "csc", "CSR": "csr", "SymCSC": "symcsc",
            "BSR": "bsr", "ShardedCSC": "sharded"}[src]
    X = _sources()[name]
    kw = {"block": 2} if target == "bsr" else {}
    # one shard: the reference's default mesh spans every jax device
    jkw = {"mesh": jax_mesh(1)} if target == "sharded" else kw
    pkw = {"mesh": make_data_mesh(1, device="cpu")} if target == "sharded" \
        else kw
    want = jformats._CONVERTERS[(type(X), target)](X, **jkw)
    got = formats._CONVERTERS[(type(to_port(X)), target)](to_port(X), **pkw)
    assert_same(got, want)


@pytest.mark.parametrize("src,target", [
    ("csr", "symcsc"), ("csr", "bsr"), ("symcsc", "csr"), ("bsr", "csr"),
    ("symcsc", "bsr"), ("bsr", "symcsc"), ("coo", "coo"), ("csc", "csc"),
])
def test_hub_conversions_match_reference(src, target):
    X = _sources()[src]
    kw = {"block": 2} if target == "bsr" else {}
    assert_same(convert(to_port(X), target, **kw), jconvert(X, target, **kw))


def test_rectangular_padded_conversions_match_reference():
    A = rect_csc()
    for target in ("coo", "csr"):
        assert_same(convert(to_port(A), target), jconvert(A, target))
    R = jconvert(A, "csr")
    assert_same(convert(to_port(R), "csc"), jconvert(R, "csc"))
    assert_same(convert(to_port(R), "coo"), jconvert(R, "coo"))
    # a COO with padding rows re-plans into both compressed formats
    C = jconvert(A, "coo")
    for target in ("csc", "csr"):
        assert_same(convert(to_port(C), target), jconvert(C, target))
    assert_same(convert(to_port(A), "bsr", block=4),
                jconvert(A, "bsr", block=4))


def test_random_float_values_move_exactly():
    """Conversions that only move values are exact on any data."""
    A, (rows, cols, _) = sym_csc(seed=5)
    v = np.random.default_rng(5).standard_normal(rows.size) \
        .astype(np.float32)
    Af = jplan(jnp.asarray(rows), jnp.asarray(cols), A.shape).assemble(
        jnp.asarray(v))
    for target in ("coo", "csr", "bsr"):
        kw = {"block": 3} if target == "bsr" else {}
        assert_same(convert(to_port(Af), target, **kw),
                    jconvert(Af, target, **kw))


@pytest.mark.parametrize("slack", [0, 5])
def test_symcsc_round_trip(slack):
    A, _ = sym_csc(seed=2, nzmax_slack=slack)
    S = convert(to_port(A), "symcsc")
    assert isinstance(S, SymCSC)
    assert_same(S, jconvert(A, "symcsc"))
    back = convert(S, "csc")
    assert_same(back, jconvert(jconvert(A, "symcsc"), "csc"))
    torch.testing.assert_close(back.to_dense(), to_port(A).to_dense(),
                               rtol=0, atol=0)
    torch.testing.assert_close(S.to_dense(), to_port(A).to_dense(),
                               rtol=0, atol=0)
    # the expanded count: diagonal dense, both triangles
    assert matlab.nnz_of(S) == jnnz_of(jconvert(A, "symcsc"))
    assert matlab.nnz_of(S) == 2 * int(S.nnz) + S.M


@pytest.mark.parametrize("block", [1, 2, 3, 4])
def test_bsr_round_trip(block):
    A, _ = sym_csc(seed=3)
    B = convert(to_port(A), "bsr", block=block)
    assert isinstance(B, BSR) and B.block == block
    assert (B.Mb, B.Nb) == (12 // block, 12 // block)
    assert_same(B, jconvert(A, "bsr", block=block))
    back = convert(B, "csc")
    assert_same(back, jconvert(jconvert(A, "bsr", block=block), "csc"))
    torch.testing.assert_close(back.to_dense(), to_port(A).to_dense(),
                               rtol=0, atol=0)
    assert matlab.nnz_of(B) == jnnz_of(jconvert(A, "bsr", block=block))
    assert matlab.nnz_of(B) == int(B.nnz) * block * block


def test_find_reports_the_expanded_structure():
    from repro.sparse import find as jfind

    A, _ = sym_csc(seed=4)
    for fmt in ("symcsc", "bsr", "csr"):
        kw = {"block": 2} if fmt == "bsr" else {}
        X = jconvert(A, fmt, **kw)
        for got, want in zip(matlab.find(to_port(X)), jfind(X)):
            np.testing.assert_array_equal(got, np.asarray(want))


def _message(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def test_symcsc_errors_match_reference():
    rect = rect_csc()
    assert _message(convert, to_port(rect), "symcsc") == \
        _message(jconvert, rect, "symcsc")
    assert "keep the plain 'csc' format for rectangular" in \
        _message(convert, to_port(rect), "symcsc")[1]
    # asymmetric structure: one mirror missing
    rows = np.array([0, 1, 2, 2], np.int32)
    cols = np.array([1, 0, 0, 2], np.int32)
    vals = np.array([1.0, 1.0, 2.0, 3.0], np.float32)
    A = jplan(jnp.asarray(rows), jnp.asarray(cols), (3, 3)).assemble(
        jnp.asarray(vals))
    err = _message(convert, to_port(A), "symcsc")
    assert err == _message(jconvert, A, "symcsc")
    assert "structure is not symmetric" in err[1]
    # symmetric structure, asymmetric values
    rows = np.array([0, 1, 2], np.int32)
    cols = np.array([1, 0, 2], np.int32)
    A = jplan(jnp.asarray(rows), jnp.asarray(cols), (3, 3)).assemble(
        jnp.asarray(np.array([1.0, 2.0, 3.0], np.float32)))
    err = _message(convert, to_port(A), "symcsc")
    assert err == _message(jconvert, A, "symcsc")
    assert "values are not symmetric" in err[1]


def test_bsr_errors_match_reference():
    A = rect_csc()  # 12 x 8
    for block in (5, 0, -1):
        err = _message(convert, to_port(A), "bsr", block=block)
        assert err == _message(jconvert, A, "bsr", block=block)
    assert "not divisible by block=5" in \
        _message(convert, to_port(A), "bsr", block=5)[1]


def test_registry_errors_match_reference():
    A = rect_csc()
    assert _message(convert, to_port(A), "ell") == \
        _message(jconvert, A, "ell")
    assert _message(format_of, object()) == \
        _message(jformats.format_of, object())
    assert _message(convert, object(), "csc") == \
        _message(jconvert, object(), "csc")


def test_from_arrays_keeps_dtypes_and_rejects_unknown_formats():
    A, _ = sym_csc()
    S = to_port(jconvert(A, "symcsc"))
    assert S.data.dtype == torch.float32 and S.indices.dtype == torch.int32
    with pytest.raises(ValueError, match="from_arrays takes one of"):
        from_arrays("csc", {}, (1, 1), device="cpu")
    assert isinstance(to_port(jconvert(A, "csr")), CSR)
    assert isinstance(to_port(A), CSC)


def test_csr_to_dense_and_coo_dense_agree_with_reference():
    A = rect_csc()
    for fmt in ("csr", "coo", "csc"):
        X = jconvert(A, fmt)
        np.testing.assert_array_equal(to_port(X).to_dense().numpy(),
                                      np.asarray(X.to_dense()))
