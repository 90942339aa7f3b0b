"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), function by function, on the CPU.

The same seeded numpy inputs go through both.  Tolerances, relative to
the largest magnitude of the reference's output:

* float32: ``F32_RTOL = 1e-5`` (measured about 1e-6: the cumsum and the
  multi-operand einsums contract in another order than XLA's);
* bfloat16: ``BF16_RTOL = 4e-2`` (as ``test_torch_models``): the
  projections, the conv's output and ``y * silu(z)`` round to bf16 in
  both packages, in another order.

Both published configs have ``n_groups = 1``, which would hide a tiling
bug in the B/C broadcast (``jnp.repeat`` is ``repeat_interleave``, not
``Tensor.repeat``), so every scan and block runs with 1 and 2 groups.
The chunked scan runs at ``S`` a multiple of the chunk, ``S % Q != 0``
(the last chunk padded), ``S < Q`` and ``S == 1``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

F32_RTOL = 1e-5
BF16_RTOL = 4e-2
#: the chunked scan's final state against a float64 step-by-step
#: recurrence of the same float32 inputs
STEPWISE_RTOL = 1e-5


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfg(dtype="float32", groups=1, **ssm):
    cfg = get_config("mamba2_780m").reduced(dtype=dtype)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, n_groups=groups, **ssm))


def _both(x, dtype):
    """``x`` (numpy float32) as a jax and a torch array of ``dtype``:
    both round to nearest even, so the two hold the same values."""
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                 dtype))


def _block_params(cfg, seed=0):
    tree = jax.tree.map(np.asarray, jssm.init_mamba(jax.random.key(seed),
                                                    cfg))
    return jax.tree.map(jnp.asarray, tree), tmodel._node(tree, "cpu")


def _scan_inputs(rng, B, S, H, P, G, N, dt_scale=1.0):
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(B, S, H)))) * dt_scale).astype(
        np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


def _stepwise_state(xh, dt, A, Bm):
    """h_t = exp(dt_t A) h_{t-1} + B_t (x_t dt_t), in float64, token by
    token; group g feeds heads g * H/G .. (g+1) * H/G - 1."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2:]
    Bh = np.repeat(Bm.astype(np.float64), H // G, axis=2)   # [B,S,H,N]
    h = np.zeros((B, H, N, P))
    for t in range(S):
        d = dt[:, t].astype(np.float64)                      # [B,H]
        h = h * np.exp(d * A)[..., None, None] + np.einsum(
            "bhn,bhp->bhnp", Bh[:, t], xh[:, t] * d[..., None])
    return h


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("groups", [1, 2])
def test_split_proj_matches_reference(groups):
    cfg = _cfg(groups=groups)
    s = cfg.ssm
    width = 2 * s.d_inner(cfg.d_model) + 2 * groups * s.d_state \
        + s.n_heads(cfg.d_model)
    proj = np.random.default_rng(0).normal(size=(2, 3, width)).astype(
        np.float32)
    want = jssm._split_proj(cfg, jnp.asarray(proj))
    got = tssm._split_proj(cfg, torch.from_numpy(proj))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 3, 17])
def test_causal_conv_matches_reference(S, dtype):
    rng = np.random.default_rng(S)
    W, ch = 4, 24
    x, xt = _both(rng.normal(size=(2, S, ch)).astype(np.float32), dtype)
    w, wt = _both(rng.normal(size=(W, ch)).astype(np.float32), dtype)
    b, bt = _both(rng.normal(size=(ch,)).astype(np.float32), dtype)
    want = jssm._causal_conv(x, w, b)
    got = tssm._causal_conv(xt, wt, bt)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    assert _rel_err(got, want) <= tol


def test_softplus_matches_jax_past_torchs_threshold():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; torch's is
    ``log1p(exp(x))`` up to 20 and x past it: within two float32 ulps
    (the two libraries' exp and log1p round differently)."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        np.linspace(19.9, 20.1, 201)]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S,chunk", [(32, 16), (37, 16), (5, 16), (1, 16),
                                     (16, 16)],
                         ids=["multiple", "pads_last", "S_lt_Q", "S_1",
                              "one_chunk"])
def test_ssd_chunked_matches_reference(S, chunk, groups):
    rng = np.random.default_rng(S * 10 + groups)
    B, H, P, N = 2, 4, 8, 6
    xh, dt, A, Bm, Cm = _scan_inputs(rng, B, S, H, P, groups, N)
    yj, hj = jssm.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                              chunk=chunk)
    yt, ht = tssm.ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)),
                              chunk=chunk)
    assert yt.shape == (B, S, H, P) and ht.shape == (B, H, N, P)
    assert yt.dtype == ht.dtype == torch.float32
    assert _rel_err(yt, yj) <= F32_RTOL
    assert _rel_err(ht, hj) <= F32_RTOL
    # the padded steps (dt = 0) leave the state where S tokens put it
    h64 = _stepwise_state(xh, dt, A, Bm)
    assert _rel_err(ht, h64) <= STEPWISE_RTOL


def test_ssd_chunked_groups_are_not_tiled():
    """Two groups feed heads (0, 1) and (2, 3): swapping the groups'
    inputs swaps the head pairs' outputs (``Tensor.repeat`` would feed
    heads (0, 2) and (1, 3))."""
    rng = np.random.default_rng(3)
    xh, dt, A, Bm, Cm = map(torch.from_numpy, _scan_inputs(
        rng, 1, 9, 4, 3, 2, 5))
    xh = xh[:, :, [0, 0, 0, 0]]
    dt = dt[:, :, [0, 0, 0, 0]]
    A = A[[0, 0, 0, 0]]
    y, _ = tssm.ssd_chunked(xh, dt, A, Bm, Cm, chunk=4)
    ys, _ = tssm.ssd_chunked(xh, dt, A, Bm.flip(2), Cm.flip(2), chunk=4)
    assert torch.equal(y[:, :, 0], y[:, :, 1])
    assert torch.equal(y[:, :, 2], y[:, :, 3])
    assert not torch.allclose(y[:, :, 0], y[:, :, 2])
    assert torch.equal(ys[:, :, :2], y[:, :, 2:])


@pytest.mark.parametrize("S", [37, 16])
def test_ssd_chunked_gradient_is_finite_at_large_dt(S):
    """Where ``dt`` is large the non-causal half of ``cum_q - cum_k`` is
    large and positive: its ``exp`` overflows, so the mask goes on the
    exponent.  The gradient is finite and the reference's."""
    rng = np.random.default_rng(7)
    xh, dt, A, Bm, Cm = _scan_inputs(rng, 2, S, 4, 8, 2, 6, dt_scale=60.0)
    assert float(np.max(-np.cumsum(dt[0, :16, 0] * A[0]))) > 100

    def jloss(*args):
        y, h = jssm.ssd_chunked(*args, chunk=16)
        return jnp.sum(y * jnp.cos(y)) + jnp.sum(h)

    want = jax.grad(jloss, argnums=(0, 1, 3, 4))(
        *map(jnp.asarray, (xh, dt, A, Bm, Cm)))
    args = [torch.from_numpy(a).requires_grad_(i in (0, 1, 3, 4))
            for i, a in enumerate((xh, dt, A, Bm, Cm))]
    y, h = tssm.ssd_chunked(*args, chunk=16)
    got = torch.autograd.grad(torch.sum(y * torch.cos(y)) + torch.sum(h),
                              [args[i] for i in (0, 1, 3, 4)])
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel_err(g, w) <= F32_RTOL


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("dtype,groups", [("float32", 1), ("float32", 2),
                                          ("bfloat16", 1), ("bfloat16", 2)])
@pytest.mark.parametrize("S", [2, 21])
def test_mamba_forward_matches_reference(S, dtype, groups, return_state):
    cfg = _cfg(dtype, groups)
    pj, pt = _block_params(cfg, seed=S)
    x, xt = _both(np.random.default_rng(S).normal(
        size=(2, S, cfg.d_model)).astype(np.float32), dtype)
    want = jssm.mamba_forward(pj, x, cfg, return_state=return_state)
    with torch.inference_mode():
        got = tssm.mamba_forward(pt, xt, cfg, return_state=return_state)
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    if return_state:
        (got, (ht, ct)), (want, (hj, cj)) = got, want
        assert ht.dtype == torch.float32 and ht.shape == hj.shape
        assert ct.dtype == xt.dtype and ct.shape == cj.shape
        assert _rel_err(ht, hj) <= tol
        # the conv state is the raw projection rows, padded in front
        assert _rel_err(ct, cj) <= tol
        if S < cfg.ssm.conv_width - 1:
            assert not ct[:, :cfg.ssm.conv_width - 1 - S].any()
    assert got.dtype == xt.dtype and got.shape == want.shape
    assert _rel_err(got, want) <= tol


@pytest.mark.parametrize("dtype,groups", [("float32", 1), ("float32", 2),
                                          ("bfloat16", 1), ("bfloat16", 2)])
def test_mamba_decode_matches_reference(dtype, groups):
    cfg = _cfg(dtype, groups)
    s = cfg.ssm
    H, di = s.n_heads(cfg.d_model), s.d_inner(cfg.d_model)
    conv_ch = di + 2 * groups * s.d_state
    pj, pt = _block_params(cfg, seed=groups)
    rng = np.random.default_rng(groups)
    x, xt = _both(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32),
                  dtype)
    st = rng.normal(size=(2, H, s.d_state, s.head_dim)).astype(np.float32)
    cache_dtype = "float32" if dtype == "float32" else "bfloat16"
    cv, cvt = _both(rng.normal(size=(2, s.conv_width - 1, conv_ch)).astype(
        np.float32), cache_dtype)
    st_t = torch.from_numpy(st)
    keep = (st_t.clone(), cvt.clone())
    oj, hj, cj = jssm.mamba_decode(pj, x, jnp.asarray(st), cv, cfg)
    with torch.inference_mode():
        ot, ht, ct = tssm.mamba_decode(pt, xt, st_t, cvt, cfg)
    assert torch.equal(st_t, keep[0]) and torch.equal(cvt, keep[1])
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    assert ot.dtype == xt.dtype and ht.dtype == torch.float32
    assert ct.dtype == cvt.dtype and ct.shape == cj.shape
    assert _rel_err(ot, oj) <= tol and _rel_err(ht, hj) <= tol
    # the window moves on one row: the two oldest rows are the old cache's
    assert torch.equal(ct[:, :-1], cvt[:, 1:])
    assert _rel_err(ct, cj) <= tol


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num", [1, 2, 7, 8, 48, 112])
def test_linspace_is_the_references_bit_for_bit(num):
    want = np.asarray(jnp.linspace(1.0, 16.0, num).astype(jnp.float32))
    got = tssm._linspace(1.0, 16.0, num, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_structure_and_fixed_leaves(arch, dtype):
    full = get_config(arch)
    # the full config's head count on a narrow model: a_log's length
    H = full.ssm.n_heads(full.d_model)
    cfg = get_config(arch).reduced(dtype=dtype, d_model=16 * H)
    gen = torch.Generator().manual_seed(0)
    got = tssm.init_mamba(gen, cfg)
    ref = jssm.init_mamba(jax.random.key(0), cfg)
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    have = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tmodel._tree(got))[0]}
    assert set(have) == set(want)
    for k, v in want.items():
        assert have[k].shape == v.shape, k
    leaves = dict(got.named_parameters())
    for name in ("a_log", "d_skip", "dt_bias"):
        assert leaves[name].dtype == torch.float32, name
    for name in ("in_proj_in", "conv_w", "conv_b", "gnorm.scale",
                 "out_proj_out"):
        assert leaves[name].dtype == getattr(torch, dtype), name
    assert leaves["a_log"].shape == (H,)
    for name in ("d_skip", "dt_bias", "conv_b", "gnorm.scale"):
        k = "['" + name.replace(".", "']['") + "']"
        np.testing.assert_array_equal(have[k], np.asarray(want[k],
                                                          np.float32))
    # log(linspace): the linspace bit for bit, XLA's log and torch's
    # within one float32 ulp of each other
    np.testing.assert_array_max_ulp(have["['a_log']"],
                                    np.asarray(want["['a_log']"]), maxulp=1)
    # the random leaves: the reference's scales
    w = leaves["in_proj_in"].float()
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(leaves["conv_w"].float().std()) - 0.2) < 0.02
