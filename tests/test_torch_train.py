"""The port's LM training path against the JAX package, on the CPU.

The same weights (the reference's init, carried across with
``params_from_numpy``) and the same seeded batches go through both
packages at reduced sizes: ``loss_fn`` and its gradients, activation
checkpointing, the learning-rate schedule, AdamW, the train step and the
train state carried across.  Tolerances, relative to the largest
magnitude of the reference's leaf:

* float32 ``loss_fn`` and gradients: ``F32_RTOL = 1e-5`` (measured about
  1.9e-6: the two packages' float32 matmuls round in other orders);
* bfloat16 ``loss_fn``: ``BF16_RTOL = 4e-2`` (as ``test_torch_models``);
* AdamW on identical gradients: ``OPT_RTOL = 1e-6`` (only the global
  norm's summation order and ``pow``'s last bit differ);
* the train step: losses and ``grad_norm`` within ``F32_RTOL``.  The
  parameters after a step are not held to a relative tolerance: Adam's
  first update is about ``lr * sign(g)``, so a gradient within rounding
  of 0 may take the other sign on one side and move by ``2 lr``.  Every
  parameter's change is held within ``2 lr`` of the reference's, and
  after the first step within ``TIGHT * lr`` where ``|mu|`` (the clipped
  gradient's trace) is above ``1e-3`` of its leaf's largest (later
  steps start from parameters that differ already).  With ``compress_grads``, a
  gradient within ``1e-6`` of a bf16 rounding boundary rounds the other
  way on one side: after the first step its ``ef`` entries then differ
  by one bf16 spacing, every other entry within ``F32_RTOL`` of the
  leaf's gradient scale.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import model as jmodel
from repro.models import runtime_flags as jflags
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import runtime_flags as tflags
from repro_torch.models.layers import (stacked_leaves, tree_leaves,
                                       tree_unflatten)
from repro_torch.train import optimizer as topt
from repro_torch.train import sparse_grads as tsg
from repro_torch.train import train_step as tts

torch.set_num_threads(1)

F32_RTOL = 1e-5
BF16_RTOL = 4e-2
OPT_RTOL = 1e-6
TIGHT = 1e-3


def _np32(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _named(tree, prefix: str = "") -> dict:
    """``{name: array}`` of a numpy pytree, names ``/``-joined."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _np32(v)
    return out


def _port_named(tree) -> dict:
    """The same of a port tree, stacks stacked."""
    def host(t):
        return t.detach().float().numpy()
    return {n: np.stack([host(p) for p in parts]) if stacked
            else host(parts[0]) for n, parts, stacked in stacked_leaves(tree)}


def _rel(got, want) -> float:
    scale = float(np.max(np.abs(want)))
    return float(np.max(np.abs(got - want))) / (scale if scale else 1.0)


def _batch(cfg, B, S, seed, ignore=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab[0, :ignore] = -1
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})


def _weights(cfg, seed=0):
    params = jmodel.init_model(jax.random.key(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype,tol", [
    ("olmoe_1b_7b", "float32", F32_RTOL),
    ("olmo_1b", "float32", F32_RTOL),
    ("olmo_1b", "bfloat16", BF16_RTOL),
])
def test_loss_fn_and_gradients_match_reference(arch, dtype, tol):
    cfg = jax_get_config(arch).reduced(dtype=dtype)
    params, tree = _weights(cfg)
    bj, bt = _batch(cfg, 2, 16, seed=1, ignore=3)  # 3 ignored labels
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, bj, cfg, kv_chunk=8))(params)
    p = tmodel.params_from_numpy(tree, cfg, device="cpu")
    tloss = tmodel.loss_fn(p, bt, cfg, kv_chunk=8)
    tgrads = torch.autograd.grad(tloss, tree_leaves(p))
    assert abs(float(tloss.detach()) - float(loss)) <= tol * abs(float(loss))
    want = _named(jax.tree.map(np.asarray, grads))
    got = _port_named(tree_unflatten(p, tgrads))
    assert set(got) == set(want)
    assert {k: got[k].shape for k in got} == {k: want[k].shape for k in want}
    worst = {k: _rel(got[k], want[k]) for k in want}
    assert max(worst.values()) <= tol, worst


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------
def _counted(monkeypatch):
    """Count the MoE dispatches and the embedding gradient's counting
    sorts (each one B12 and one B11 launch on the card)."""
    calls = {"dispatch": 0, "embed_sort": 0}
    dispatch, sort = tmoe._group_dispatch, tsg.counting_sort

    def counted_dispatch(*a, **kw):
        calls["dispatch"] += 1
        return dispatch(*a, **kw)

    def counted_sort(*a, **kw):
        calls["embed_sort"] += 1
        return sort(*a, **kw)

    monkeypatch.setattr(tmoe, "_group_dispatch", counted_dispatch)
    monkeypatch.setattr(tsg, "counting_sort", counted_sort)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_unchecked_blocks(policy, dtype, monkeypatch):
    cfg = get_config("olmoe_1b_7b").reduced(dtype=dtype)
    L = cfg.n_layers
    p = tmodel.init_model(cfg, seed=3, device="cpu")
    _, bt = _batch(cfg, 2, 16, seed=4)
    leaves = tree_leaves(p)
    calls = _counted(monkeypatch)

    monkeypatch.setattr(tflags, "REMAT", policy)
    loss = tmodel.loss_fn(p, bt, cfg, kv_chunk=8)
    got = torch.autograd.grad(loss, leaves)
    # the forward's L dispatches, the recompute's L, the embedding's sort
    assert calls == {"dispatch": 2 * L, "embed_sort": 1}

    calls.update(dispatch=0, embed_sort=0)
    with monkeypatch.context() as m:
        m.setattr(tmodel, "_ckpt", lambda fn: fn)
        want_loss = tmodel.loss_fn(p, bt, cfg, kv_chunk=8)
        want = torch.autograd.grad(want_loss, leaves)
    assert calls == {"dispatch": L, "embed_sort": 1}
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    # serving records nothing: no checkpoint, no recompute
    calls.update(dispatch=0, embed_sort=0)
    with torch.inference_mode():
        tmodel.forward(p, bt, cfg, kv_chunk=8)
    assert calls == {"dispatch": L, "embed_sort": 0}


def test_remat_flag_mirrors_the_reference():
    assert tflags.REMAT == jflags.REMAT == "full"
    try:
        tflags.set_remat("dots")
        assert tflags.remat() == "dots"
    finally:
        tflags.set_remat("full")
    assert tflags.remat() == "full"


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_dots_policy_keeps_the_matmul_outputs(monkeypatch):
    """Under ``"dots"`` the backward recomputes none of the blocks'
    unbatched matmuls (the unembedding's runs outside the blocks)."""
    cfg = get_config("olmoe_1b_7b").reduced(dtype="float32")
    p = tmodel.init_model(cfg, seed=3, device="cpu")
    _, bt = _batch(cfg, 2, 16, seed=4)
    backward = {}
    for policy in ("full", "dots"):
        monkeypatch.setattr(tflags, "REMAT", policy)
        with _CountMM() as fwd:
            loss = tmodel.loss_fn(p, bt, cfg, kv_chunk=8)
        with _CountMM() as bwd:
            torch.autograd.grad(loss, tree_leaves(p))
        backward[policy] = bwd.n
    assert backward["full"] - backward["dots"] == fwd.n - 1 > 0


def test_train_step_dispatches_per_microbatch(monkeypatch):
    cfg = get_config("olmoe_1b_7b").reduced()
    tcfg = tts.TrainConfig(microbatches=2, kv_chunk=8)
    state = tts.init_train_state(tmodel.init_model(cfg, seed=0,
                                                   device="cpu"), tcfg)
    _, bt = _batch(cfg, 4, 16, seed=5)
    calls = _counted(monkeypatch)
    tts.make_train_step(cfg, tcfg)(state, bt)
    n, L = tcfg.microbatches, cfg.n_layers
    assert calls == {"dispatch": n * 2 * L, "embed_sort": n}


# ---------------------------------------------------------------------------
# the schedule and AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("warmup", [0, 1, 20])
def test_lr_at_matches_reference_bit_for_bit(warmup):
    """Against the reference evaluated op by op (as its own tests call
    it); under ``jax.jit`` XLA's fusion moves the reference's own
    schedule by up to 7 float32 ulp, which no port can follow."""
    jc = jopt.OptConfig(lr=3e-4, warmup_steps=warmup, total_steps=100)
    tc = topt.OptConfig(lr=3e-4, warmup_steps=warmup, total_steps=100)
    steps = np.arange(121, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_at(jc, s))(
        jnp.asarray(steps)))
    got = topt.lr_at(tc, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    for s in (0, warmup, 99):  # the 0-d count the optimizer passes
        one = topt.lr_at(tc, torch.tensor(s, dtype=torch.int32))
        assert one.numpy().tobytes() == np.asarray(
            jopt.lr_at(jc, jnp.asarray(s, jnp.int32))).tobytes()


@pytest.mark.parametrize("warmup", [0, 1, 20])
def test_lr_at_default_horizon_within_the_cosines_last_bit(warmup):
    """Over the default 10,000 steps the rates differ on under 1% of the
    steps, each by less than the last bit of the cosine scaled by the
    schedule's amplitude (``eps32 * lr``): the port rounds float64's
    cosine, the reference's CPU float32 ``cos`` is not correctly
    rounded (near the end, where ``1 + cos`` cancels, that is a few ulp
    of the small rate)."""
    jc = jopt.OptConfig(warmup_steps=warmup)
    tc = topt.OptConfig(warmup_steps=warmup)
    steps = np.arange(jc.total_steps + 20, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_at(jc, s))(
        jnp.asarray(steps)))
    got = topt.lr_at(tc, torch.from_numpy(steps)).numpy()
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= np.finfo(np.float32).eps * jc.lr
    assert np.count_nonzero(diff) < 0.01 * len(steps)
    assert not np.any(diff[:warmup + 1])  # the warm-up has no cosine


@pytest.mark.parametrize("clip_norm", [1e9, 0.05], ids=["unclipped",
                                                        "clipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(clip_norm, dtype):
    """Within ``OPT_RTOL`` when nothing is clipped.  Clipped, every
    gradient is scaled by ``clip / |g|``, whose norm adds in another
    order on each side: ``mu`` and ``master`` then move by up to the
    norm's relative difference ``dn`` (measured under 1.1e-6), ``nu``
    (quadratic in the scale) by up to ``2 dn``; each is held to that,
    plus ``OPT_RTOL``'s float32 rounding."""
    cfg = jax_get_config("olmoe_1b_7b").reduced(dtype=dtype)
    params, tree = _weights(cfg, seed=2)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=4, clip_norm=clip_norm)
    jc, tc = jopt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    jstate = jopt.init_opt_state(params, jc)
    p = tmodel.params_from_numpy(tree, cfg, device="cpu")
    tstate = topt.init_opt_state(p, tc)
    rng = np.random.default_rng(3)
    norms, dn = [], 0.0
    for _ in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * 0.1).astype(np.float32), tree)
        jg = jax.tree.map(lambda a, q: jnp.asarray(a, q.dtype), g, params)
        gt = tmodel.params_from_numpy(jax.tree.map(
            np.asarray, jg), cfg, device="cpu")
        jnew, jstate, jm = jopt.adamw_update(jg, jstate, jc)
        tnew, tstate, tm = topt.adamw_update(gt, tstate, tc)
        norms.append(float(jm["grad_norm"]))
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - norms[-1]) <= \
            OPT_RTOL * norms[-1]
        if clip_norm < norms[-1]:
            dn = max(dn, abs(float(tm["grad_norm"]) / norms[-1] - 1))
        want = _named(jax.tree.map(np.asarray, jstate))
        got = _port_named({k: tstate[k] for k in ("master", "mu", "nu")})
        got["count"] = tstate["count"].numpy()
        assert set(got) == set(want)
        assert int(got["count"]) == int(want["count"])
        for k in (k for k in want if k != "count"):
            tol = OPT_RTOL + (2 if k.startswith("nu/") else 1) * dn
            assert _rel(got[k], want[k]) <= tol, k
        newp = _port_named(tnew)
        for k, v in _named(jax.tree.map(np.asarray, jnew)).items():
            if dtype == "float32":
                assert _rel(newp[k], v) <= OPT_RTOL + dn, k
        # the new parameters are the master cast to each gradient's dtype
        for a, m, gl in zip(tree_leaves(tnew), tree_leaves(tstate["master"]),
                            tree_leaves(gt)):
            assert a.dtype == gl.dtype and torch.equal(a, m.to(gl.dtype))
    assert (min(norms) > clip_norm) == (clip_norm < 1)


def test_adamw_matches_hand_rolled_on_quadratic():
    """Minimize ||x - t||^2; compare against a hand-rolled AdamW (the
    reference's ``test_adamw_matches_reference_on_quadratic``)."""
    t = np.asarray([1.0, -2.0, 3.0])
    cfg = topt.OptConfig(lr=0.1, warmup_steps=0, total_steps=10_000,
                         weight_decay=0.0, clip_norm=1e9, b1=0.9, b2=0.999,
                         eps=1e-8, min_lr_frac=1.0)
    state = topt.init_opt_state({"x": torch.zeros(3)}, cfg)
    m = np.zeros(3); v = np.zeros(3); xr = np.zeros(3)
    for i in range(25):
        g = 2 * (state["master"]["x"].numpy() - t)
        x, state, _ = topt.adamw_update(
            {"x": torch.from_numpy(g.astype(np.float32))}, state, cfg)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** (i + 1)); vh = v / (1 - 0.999 ** (i + 1))
        xr = xr - 0.1 * mh / (np.sqrt(vh) + 1e-8)
        np.testing.assert_allclose(x["x"].numpy(), xr, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_f32():
    cfg = jax_get_config("olmoe_1b_7b").reduced(dtype="float32")
    params, tree = _weights(cfg, seed=0)
    return cfg, params, tree, _batch(cfg, 4, 16, seed=0)


@pytest.mark.parametrize("compress", [True, False], ids=["ef", "no_ef"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(moe_f32, microbatches, compress):
    cfg, params, tree, (bj, bt) = moe_f32
    kw = dict(microbatches=microbatches, compress_grads=compress, kv_chunk=8)
    jcfg = jts.TrainConfig(opt=jopt.OptConfig(lr=1e-3, warmup_steps=0), **kw)
    tcfg = tts.TrainConfig(opt=topt.OptConfig(lr=1e-3, warmup_steps=0), **kw)
    jstate = jts.init_train_state(params, jcfg)
    jstep = jax.jit(jts.make_train_step(cfg, jcfg))
    state = tts.init_train_state(
        tmodel.params_from_numpy(tree, cfg, device="cpu"), tcfg)
    step = tts.make_train_step(cfg, tcfg)
    gscale = {}
    for s in range(3):
        before = _named(jax.tree.map(np.asarray, jstate))
        jstate, jm = jstep(jstate, bj)
        out, tm = step(state, bt)
        assert out is state  # consumed: updated in place
        assert int(tm["step"]) == int(jm["step"]) == s
        assert int(state["step"]) == s + 1
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                F32_RTOL * abs(float(jm[k])), k
        # under jit, XLA's fusion moves the reference's schedule by a few
        # ulp (test_lr_at_matches_reference_bit_for_bit)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= \
            OPT_RTOL * float(jm["lr"])
        want = _named(jax.tree.map(np.asarray, jstate))
        got = _named(tts.train_state_to_numpy(state))
        assert set(got) == set(want) and ("ef/embed/embedding" in got) == \
            compress
        assert int(got["opt/count"]) == int(want["opt/count"]) == s + 1
        lr = float(jm["lr"])
        for k in (k for k in want if k.startswith("params/")):
            mu = np.abs(want["opt/mu/" + k[len("params/"):]])
            dd = np.abs((got[k] - before[k]) - (want[k] - before[k]))
            assert dd.max() <= 2 * lr * (1 + 1e-3), k
            if s == 0:  # about lr * sign(g): tight where g is clear of 0
                sure = mu > 1e-3 * mu.max()
                assert dd[sure].max() <= TIGHT * lr, k
        if compress and s == 0:
            for k in (k for k in want if k.startswith("ef/")):
                _check_first_residual(got[k], want[k])


def _check_first_residual(got, want):
    """``ef`` after the first step, ``w - bf16(w)`` of the same gradient
    ``w`` up to float32 noise: each entry within ``F32_RTOL`` of the
    gradient scale, or, where ``w`` rounded the other way on one side,
    off by one bf16 spacing (a power of two no less than the two
    residuals' sum, since each is at most half of it)."""
    scale = 512 * np.abs(want).max()  # ef's largest is half a bf16 ulp
    tol = F32_RTOL * scale
    d = np.abs(got.astype(np.float64) - want)
    flipped = d > tol
    u = 2.0 ** np.round(np.log2(d[flipped]))
    assert np.all(np.abs(d[flipped] - u) <= tol)
    assert np.all(u + tol >= np.abs(got[flipped]) + np.abs(want[flipped]))
    assert np.all(u <= 2 * scale * 2.0 ** -7)


def test_microbatch_accumulation_matches_full_batch():
    """m microbatches of B/m give the same update as one batch (the
    reference's ``test_microbatch_accumulation_matches_full_batch``)."""
    cfg = get_config("olmo_1b").reduced(n_layers=1, dtype="float32")
    _, bt = _batch(cfg, 4, 16, seed=1)
    outs = []
    for m in (1, 2, 4):
        tcfg = tts.TrainConfig(opt=topt.OptConfig(lr=1e-3, warmup_steps=0),
                               microbatches=m, compress_grads=False,
                               kv_chunk=8)
        state = tts.init_train_state(
            tmodel.init_model(cfg, seed=1, device="cpu"), tcfg)
        state, _ = tts.make_train_step(cfg, tcfg)(state, bt)
        outs.append(tree_leaves(state["params"]))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(),
                                       rtol=5e-3, atol=5e-4)


def test_error_feedback_carries_quantization_residual():
    """microbatches=2: the float32 mean of two bf16 gradients is not
    bf16-representable, so ef is non-zero (the reference's test)."""
    cfg = get_config("olmo_1b").reduced(n_layers=1)
    tcfg = tts.TrainConfig(opt=topt.OptConfig(lr=1e-4, warmup_steps=0),
                           microbatches=2, compress_grads=True, kv_chunk=8)
    _, bt = _batch(cfg, 2, 16, seed=2)
    state = tts.init_train_state(tmodel.init_model(cfg, seed=2,
                                                   device="cpu"), tcfg)
    state, _ = tts.make_train_step(cfg, tcfg)(state, bt)
    assert sum(float(e.abs().sum()) for e in tree_leaves(state["ef"])) > 0


def test_train_step_overfits_tiny_batch():
    """The reference's ``test_train_step_overfits_tiny_batch``."""
    cfg = get_config("olmo_1b").reduced(n_layers=2)
    tcfg = tts.TrainConfig(
        opt=topt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60),
        microbatches=1, compress_grads=True, kv_chunk=8,
    )
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)).astype(
        np.int32)) for k in ("tokens", "labels")}
    state = tts.init_train_state(tmodel.init_model(cfg, seed=0,
                                                   device="cpu"), tcfg)
    step = tts.make_train_step(cfg, tcfg)
    first = None
    for _ in range(40):
        state, metrics = step(state, batch)
        if first is None:
            first = float(metrics["loss"])
    last = float(metrics["loss"])
    assert last < first - 1.0, (first, last)


# ---------------------------------------------------------------------------
# train states carried across
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_state():
    """The reference's reduced bf16 OLMoE train state after one step
    (mu, nu and ef non-zero), as numpy."""
    cfg = jax_get_config("olmoe_1b_7b").reduced()  # bf16, float32 router
    params, _ = _weights(cfg, seed=4)
    jcfg = jts.TrainConfig(microbatches=2, kv_chunk=8)
    jstate = jts.init_train_state(params, jcfg)
    jstate, _ = jax.jit(jts.make_train_step(cfg, jcfg))(
        jstate, _batch(cfg, 4, 16, seed=6)[0])
    return cfg, jax.tree.map(np.asarray, jstate)


@pytest.mark.parametrize("compress", [True, False], ids=["ef", "no_ef"])
def test_train_state_round_trips_the_reference(reference_state, compress):
    cfg, ref = reference_state
    if not compress:
        ref = {k: v for k, v in ref.items() if k != "ef"}
    tcfg = tts.TrainConfig(microbatches=2, compress_grads=compress,
                           kv_chunk=8)
    state = tts.train_state_from_numpy(ref, cfg, tcfg, device="cpu")
    assert state["params"]["embed"]["embedding"].dtype == torch.bfloat16
    assert state["params"]["layers"][0]["moe"]["router"].dtype == \
        torch.float32
    assert state["opt"]["count"].dtype == state["step"].dtype == torch.int32
    assert ("ef" in state) == compress
    back = _named(tts.train_state_to_numpy(state))
    want = _named(ref)
    assert set(back) == set(want)
    for k in want:
        assert back[k].dtype == want[k].dtype and \
            back[k].tobytes() == want[k].tobytes(), k


def _layout(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layout(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), str(v.dtype))
    return out


def test_init_train_state_has_the_reference_layout():
    """The reference's leaf names, shapes and dtypes (the checkpoint's
    manifest), layers stacked."""
    cfg = jax_get_config("olmoe_1b_7b").reduced()
    want = _layout(jax.eval_shape(lambda: jts.init_train_state(
        jmodel.init_model(jax.random.key(0), cfg), jts.TrainConfig())))
    state = tts.init_train_state(tmodel.init_model(cfg, seed=0,
                                                   device="cpu"),
                                 tts.TrainConfig())
    got = {n: ((len(p), *p[0].shape) if st else tuple(p[0].shape),
               str(p[0].dtype).removeprefix("torch."))
           for n, p, st in stacked_leaves(state)}
    assert got == want


def test_train_step_leaves_no_grad_fields():
    """Gradients go to float32 buffers, never into the ``.grad`` fields."""
    cfg = get_config("olmo_1b").reduced(n_layers=1)
    tcfg = tts.TrainConfig(microbatches=2, kv_chunk=8)
    state = tts.init_train_state(tmodel.init_model(cfg, seed=0,
                                                   device="cpu"), tcfg)
    keep = copy.deepcopy(state)
    state, m = tts.make_train_step(cfg, tcfg)(state, _batch(cfg, 2, 8, 0)[1])
    assert all(p.grad is None for p in tree_leaves(state["params"]))
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(keep["params"]), tree_leaves(state["params"])))
