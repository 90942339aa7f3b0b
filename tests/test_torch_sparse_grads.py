"""``SparsePattern.reduce_rows`` and the sparse embedding gradient
against the JAX package, on the CPU.

Both packages plan the same seeded triplets (duplicates and padding
included) and reduce the same rows.  Bounds:

* integer-valued rows: bit for bit under every ``accum`` mode (every
  partial sum is exact);
* random float32 rows: min/max/first/last bit for bit; a sum within
  ``2 * (n_s - 1) * eps * sum|terms|`` of the reference's per slot,
  ``n_s`` the slot's number of terms (twice the bound ``reduce_rows``
  states, one for each package's order); a mean within that over
  ``n_s`` plus one rounding;
* gradients: the gather-by-slot backward scales by 1 or 1/n_s, so
  within one float32 rounding of ``jax.grad``'s;
* the embedding gradient (``sparse_grad_embed``): the bound of a sum
  per vocabulary row, then one rounding to the table's dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import plan as jplan
from repro.train.sparse_grads import sparse_grad_embed as jembed
from repro_torch.sparse import plan as tplan
from repro_torch.train import sparse_grad_embed
from repro_torch.train.sparse_grads import embed_grad

torch.set_num_threads(1)

ACCUM = ("sum", "min", "max", "mean", "first", "last")
EPS32 = float(np.finfo(np.float32).eps)


def _stream(seed: int, L: int = 400, M: int = 23, N: int = 7,
            pad: int = 17):
    """Triplet keys with many duplicates; ``pad`` of them padding."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    rows[rng.choice(L, pad, replace=False)] = M
    return rows, cols, (M, N)


def _plans(seed: int, accum="sum", nzmax_slack=3):
    rows, cols, shape = _stream(seed)
    kw = dict(accum=accum, nzmax_slack=nzmax_slack)
    return (jplan(jnp.asarray(rows), jnp.asarray(cols), shape, **kw),
            tplan(torch.from_numpy(rows), torch.from_numpy(cols), shape,
                  method="fused", **kw))


def _rows(kind: str, L: int, seed: int, trailing=(5,)):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return rng.integers(-64, 64, (L,) + trailing).astype(np.float32)
    if kind == "int32":
        return rng.integers(-64, 64, (L,) + trailing).astype(np.int32)
    return rng.standard_normal((L,) + trailing).astype(np.float32)


def _sum_bound(pat, mat: np.ndarray) -> np.ndarray:
    """Per slot (broadcast over the trailing axes): 2 (n_s - 1) eps
    sum|terms|."""
    slot = pat.slot.numpy()
    keep = slot < pat.nzmax
    v = np.abs(mat[pat.perm.numpy()])[keep]
    s = slot[keep]
    abs_sum = np.zeros((pat.nzmax,) + mat.shape[1:], np.float64)
    np.add.at(abs_sum, s, v)
    n = np.bincount(s, minlength=pat.nzmax).reshape(
        (-1,) + (1,) * (mat.ndim - 1))
    return 2 * np.maximum(n - 1, 0) * EPS32 * abs_sum


#: int32 rows under min/max raise (test_reduce_rows_errors_match_reference)
CASES = [(a, k) for a in ACCUM
         for k in ("random", "integer", "int32", "trailing")
         if not (k == "int32" and a in ("min", "max"))]


@pytest.mark.parametrize("accum,kind", CASES)
def test_reduce_rows_matches_reference(accum, kind):
    jp, tp = _plans(1, accum)
    mat = _rows(kind if kind != "trailing" else "random", tp.L, 2,
                (2, 3) if kind == "trailing" else (5,))
    want = np.asarray(jp.reduce_rows(jnp.asarray(mat)))
    got = tp.reduce_rows(torch.from_numpy(mat)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape \
        == (tp.nzmax,) + mat.shape[1:]
    if kind in ("integer", "int32") or accum in ("min", "max", "first",
                                                 "last"):
        np.testing.assert_array_equal(got, want)
        return
    bound = _sum_bound(tp, mat)
    if accum == "mean":
        n = np.maximum(np.bincount(tp.slot.numpy()[tp.slot.numpy()
                                                   < tp.nzmax],
                                   minlength=tp.nzmax), 1)
        bound = bound / n.reshape((-1,) + (1,) * (mat.ndim - 1)) \
            + EPS32 * np.abs(want)
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


@pytest.mark.parametrize("accum", ACCUM)
def test_reduce_rows_gradient_matches_jax_grad(accum):
    jp, tp = _plans(3, accum)
    mat = _rows("random", tp.L, 4)
    w = np.random.default_rng(5).standard_normal(
        (tp.nzmax, 5)).astype(np.float32)
    want = jax.grad(lambda m: jnp.sum(jp.reduce_rows(m) * w))(
        jnp.asarray(mat))
    m = torch.from_numpy(mat).requires_grad_()
    (tp.reduce_rows(m) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want),
                               rtol=EPS32, atol=0)


@pytest.mark.parametrize("case", ["minmax_int", "rows", "accum", "complex"])
def test_reduce_rows_errors_match_reference(case):
    jp, tp = _plans(6)
    L = tp.L
    mat = {"minmax_int": np.ones((L, 2), np.int32),
           "rows": np.ones((L + 1, 2), np.float32),
           "accum": np.ones((L, 2), np.float32),
           "complex": np.ones((L, 2), np.complex64)}[case]
    accum = {"minmax_int": "min", "accum": "median", "complex": "max"}.get(
        case)
    with pytest.raises(ValueError) as want:
        jp.reduce_rows(jnp.asarray(mat), accum=accum)
    with pytest.raises(ValueError) as got:
        tp.reduce_rows(torch.from_numpy(mat), accum=accum)
    assert str(got.value) == str(want.value)


def _tokens(seed: int, shape, vocab: int) -> np.ndarray:
    """Token ids with a heavy head: many collisions, as in text."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 8, shape)
    tail = rng.integers(0, vocab, shape)
    return np.where(rng.random(shape) < 0.6, head, tail).astype(np.int32)


@pytest.mark.parametrize("upstream", ["integer", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_grad_embed_matches_jax_grad(dtype, upstream):
    V, D, shape = 300, 6, (3, 40)
    rng = np.random.default_rng(8)
    table = rng.standard_normal((V, D)).astype(np.float32)
    toks = _tokens(9, shape, V)
    g = _rows(upstream, int(np.prod(shape)), 10, (D,)).reshape(shape + (D,))
    want = jax.grad(lambda t: jnp.sum(
        jembed(t, jnp.asarray(toks)).astype(jnp.float32) * g))(
        jnp.asarray(table, dtype))
    t = torch.from_numpy(table).to(getattr(torch, dtype)).requires_grad_()
    out = sparse_grad_embed(t, torch.from_numpy(toks))
    assert torch.equal(out.detach(), t.detach()[torch.from_numpy(toks)])
    (out.float() * torch.from_numpy(g)).sum().backward()
    got = t.grad.float().numpy()
    want = np.asarray(want, np.float32)
    if upstream == "integer":
        np.testing.assert_array_equal(got, want)
        return
    flat = toks.reshape(-1)
    n = np.bincount(flat, minlength=V)[:, None]
    abs_sum = np.zeros((V, D))
    np.add.at(abs_sum, flat, np.abs(g.reshape(-1, D)))
    bound = 2 * np.maximum(n - 1, 0) * EPS32 * abs_sum
    if dtype == "bfloat16":  # then one rounding to bf16 in each package
        bound = bound + 2.0 ** -8 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound)


def test_embed_grad_is_the_dense_scatter_add():
    V, D = 50, 4
    toks = torch.from_numpy(_tokens(11, (64,), V))
    g = torch.from_numpy(_rows("integer", 64, 12, (D,)))
    want = torch.zeros(V, D).index_add_(0, toks.long(), g)
    assert torch.equal(embed_grad(toks, g, vocab=V, dtype=torch.float32),
                       want)
