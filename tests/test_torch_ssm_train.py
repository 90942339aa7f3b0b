"""The port's training path on the ``ssm`` (Mamba2-780M) and ``hybrid``
(Zamba2-7B) families against the JAX package, on the CPU, at reduced
sizes: ``loss_fn`` and its gradients (the hybrid's shared block summed
over its applications), activation checkpointing, one train step, the
train state and its checkpoints both ways, and the training launcher.

Tolerances as in ``test_torch_train``, relative to each leaf's largest
magnitude: float32 ``F32_RTOL = 1e-5`` (measured about 2e-6), bfloat16
``loss_fn`` ``BF16_RTOL = 4e-2``; a train step's parameters move within
``2 lr`` of the reference's, and within ``TIGHT * lr`` where the clipped
gradient's trace ``|mu|`` is clear of 0.  Both models keep float32
leaves (``a_log``, ``d_skip``, ``dt_bias``) inside a bf16 model.
"""
import contextlib
import io
import json
import re
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.launch import train as jlaunch
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import runtime_flags as tflags
from repro_torch.models.layers import stacked_leaves, tree_leaves, \
    tree_unflatten
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

torch.set_num_threads(1)

F32_RTOL = 1e-5
BF16_RTOL = 4e-2
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
            out[f"{prefix}{k}"] = np.asarray(v)
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


def _bits(a: np.ndarray) -> tuple:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a.shape, a.tobytes()


def _cfg(arch, dtype="float32", **kw):
    return get_config(arch).reduced(dtype=dtype, **kw)


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
@pytest.mark.parametrize("arch,dtype,kw,tol", [
    ("mamba2_780m", "float32", {}, F32_RTOL),
    ("mamba2_780m", "bfloat16", {}, BF16_RTOL),
    ("zamba2_7b", "float32", {}, F32_RTOL),
    ("zamba2_7b", "float32", {"n_layers": 4}, F32_RTOL),
], ids=["mamba2-f32", "mamba2-bf16", "zamba2-f32", "zamba2-f32-L4"])
def test_loss_fn_and_gradients_match_reference(arch, dtype, kw, tol):
    """The hybrid's shared block with 4 layers fires twice: its gradient
    is the sum over both applications."""
    cfg = _cfg(arch, dtype, **kw)
    params, tree = _weights(cfg)
    bj, bt = _batch(cfg, 2, 21, seed=1, ignore=3)  # S pads the last chunk
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, bj, cfg, kv_chunk=8))(params)
    p = tmodel.params_from_numpy(tree, cfg, device="cpu")
    tloss = tmodel.loss_fn(p, bt, cfg, kv_chunk=8)
    tgrads = torch.autograd.grad(tloss, tree_leaves(p))
    assert abs(float(tloss.detach()) - float(loss)) <= tol * abs(float(loss))
    want = {k: _np32(v) for k, v in _named(jax.tree.map(np.asarray,
                                                         grads)).items()}
    got = _port_named(tree_unflatten(p, tgrads))
    assert set(got) == set(want)
    assert {k: got[k].shape for k in got} == {k: want[k].shape for k in want}
    worst = {k: _rel(got[k], want[k]) for k in want}
    assert max(worst.values()) <= tol, worst
    if dtype == "float32":  # every leaf takes a gradient, a_log too
        assert all(np.abs(want[k]).max() > 0 for k in want), \
            [k for k in want if not np.abs(want[k]).max()]


def _counted(monkeypatch):
    """Count the Mamba blocks and the shared blocks run."""
    calls = {"mamba": 0, "shared": 0}
    mamba, shared = tmodel.mamba_forward, tmodel._shared_attn_block

    def counted_mamba(*a, **kw):
        calls["mamba"] += 1
        return mamba(*a, **kw)

    def counted_shared(*a, **kw):
        calls["shared"] += 1
        return shared(*a, **kw)

    monkeypatch.setattr(tmodel, "mamba_forward", counted_mamba)
    monkeypatch.setattr(tmodel, "_shared_attn_block", counted_shared)
    return calls


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_unchecked_blocks(policy, arch, monkeypatch):
    """Each layer, with its shared block where it fires, is one
    checkpointed unit: the backward recomputes both, and the gradients
    are those of the blocks run as they are, bit for bit."""
    cfg = _cfg(arch, n_layers=4)
    L = cfg.n_layers
    A = L // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    p = tmodel.init_model(cfg, seed=3, device="cpu")
    _, bt = _batch(cfg, 2, 21, seed=4)
    leaves = tree_leaves(p)
    calls = _counted(monkeypatch)

    monkeypatch.setattr(tflags, "REMAT", policy)
    loss = tmodel.loss_fn(p, bt, cfg, kv_chunk=8)
    got = torch.autograd.grad(loss, leaves)
    assert calls == {"mamba": 2 * L, "shared": 2 * A}

    calls.update(mamba=0, shared=0)
    with monkeypatch.context() as m:
        m.setattr(tmodel, "_ckpt", lambda fn: fn)
        want_loss = tmodel.loss_fn(p, bt, cfg, kv_chunk=8)
        want = torch.autograd.grad(want_loss, leaves)
    assert calls == {"mamba": L, "shared": A}
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the train step and the train state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
def test_train_step_matches_reference(arch):
    """One step of two microbatches with bf16 compression, from the
    reference's initial train state carried across."""
    cfg = _cfg(arch)
    params, _ = _weights(cfg, seed=0)
    bj, bt = _batch(cfg, 4, 21, seed=0)
    kw = dict(microbatches=2, compress_grads=True, kv_chunk=8)
    jcfg = jts.TrainConfig(opt=jopt.OptConfig(lr=1e-3, warmup_steps=0), **kw)
    tcfg = tts.TrainConfig(opt=topt.OptConfig(lr=1e-3, warmup_steps=0), **kw)
    jstate = jts.init_train_state(params, jcfg)
    state = tts.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                       cfg, tcfg, device="cpu")
    before = _named(jax.tree.map(np.asarray, jstate))
    jstate, jm = jax.jit(jts.make_train_step(cfg, jcfg))(jstate, bj)
    state, tm = tts.make_train_step(cfg, tcfg)(state, bt)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= \
            F32_RTOL * abs(float(jm[k])), k
    want = _named(jax.tree.map(np.asarray, jstate))
    got = _named(tts.train_state_to_numpy(state))
    assert set(got) == set(want)
    assert int(got["step"]) == int(want["step"]) == 1
    lr = float(jm["lr"])
    for k in (k for k in want if k.startswith("params/")):
        mu = np.abs(want["opt/mu/" + k[len("params/"):]])
        dd = np.abs((got[k] - before[k]) - (want[k] - before[k]))
        assert dd.max() <= 2 * lr * (1 + 1e-3), k
        sure = mu > 1e-3 * mu.max()
        assert dd[sure].max() <= TIGHT * lr, k


@pytest.fixture(scope="module")
def hybrid_bf16():
    """A reduced bf16 Zamba2 train state after one step of the reference
    (mu, nu and ef non-zero), and the port's own after one step."""
    cfg = get_config("zamba2_7b").reduced()
    jcfg = jts.TrainConfig(microbatches=2, kv_chunk=8)
    tcfg = tts.TrainConfig(microbatches=2, kv_chunk=8)
    bj, bt = _batch(cfg, 4, 16, seed=1)
    jstate = jts.init_train_state(jmodel.init_model(jax.random.key(0), cfg),
                                  jcfg)
    jstate, _ = jax.jit(jts.make_train_step(cfg, jcfg))(jstate, bj)
    state = tts.init_train_state(tmodel.init_model(cfg, seed=5,
                                                   device="cpu"), tcfg)
    state, _ = tts.make_train_step(cfg, tcfg)(state, bt)
    return cfg, tcfg, jstate, state


def test_train_state_round_trips_the_reference(hybrid_bf16):
    cfg, tcfg, jstate, _ = hybrid_bf16
    tree = jax.tree.map(np.asarray, jstate)
    state = tts.train_state_from_numpy(tree, cfg, tcfg, device="cpu")
    p = state["params"]
    assert p["layers"][0]["mamba"]["in_proj_in"].dtype == torch.bfloat16
    assert p["layers"][0]["mamba"]["a_log"].dtype == torch.float32
    assert p["shared_attn"]["q_in"].dtype == torch.bfloat16
    assert state["opt"]["master"]["shared_mlp"]["gate_in"].dtype == \
        torch.float32
    want, got = _named(tree), _named(tts.train_state_to_numpy(state))
    assert set(got) == set(want)
    assert any(k.startswith("ef/shared_attn/") for k in want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def _fresh(cfg, tcfg, seed=9):
    return tts.init_train_state(tmodel.init_model(cfg, seed=seed,
                                                  device="cpu"), tcfg)


def test_reference_checkpoint_restores_into_the_port(hybrid_bf16, tmp_path):
    cfg, tcfg, jstate, _ = hybrid_bf16
    jckpt.CheckpointManager(str(tmp_path)).save(4, jstate, blocking=True)
    restored, manifest = tckpt.CheckpointManager(str(tmp_path)).restore(
        _fresh(cfg, tcfg))
    assert manifest["step"] == 4
    want = _named(jax.tree.map(np.asarray, jstate))
    got = _named(tts.train_state_to_numpy(restored))
    assert set(got) == set(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def test_port_checkpoint_restores_into_the_reference(hybrid_bf16, tmp_path):
    cfg, tcfg, jstate, state = hybrid_bf16
    tckpt.CheckpointManager(str(tmp_path)).save(3, state, blocking=True)
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(3, jstate,
                                                        blocking=True)
    manifest, ref_manifest = (json.loads(
        (d / "step_0000000003" / "manifest.json").read_text())
        for d in (tmp_path, tmp_path / "ref"))
    assert manifest["leaves"] == ref_manifest["leaves"]
    assert manifest["dtypes"] == ref_manifest["dtypes"]
    assert manifest["dtypes"]["params/layers/mamba/a_log"] == "float32"
    assert manifest["dtypes"]["params/shared_attn/q_in"] == "bfloat16"
    tpl = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jstate)
    restored, _ = jckpt.CheckpointManager(str(tmp_path)).restore(tpl)
    want = _named(tts.train_state_to_numpy(state))
    got = _named(jax.tree.map(np.asarray, restored))
    assert set(got) == set(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _shape(line: str) -> str:
    """A printed line with its numbers blanked."""
    return re.sub(r"\d+(\.\d+)?(e[-+]\d+)?", "#", line)


def _run(main, argv) -> list:
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    return [x for x in out.getvalue().splitlines() if "STRAGGLER" not in x]


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
def test_train_main_prints_the_reference_lines(arch, tmp_path, monkeypatch):
    """The reference's launcher runs here with its state's donation off
    (queue C, C3: with it on, it cannot train these models)."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--seq", "20",
            "--log-every", "1", "--ckpt-every", "2"]
    got = _run(tlaunch.main, argv + ["--steps", "4", "--device", "cpu",
                                     "--ckpt-dir", str(tmp_path / "port")])
    jit = jax.jit
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f, donate_argnums=(), **kw: jit(f, **kw))
        want = _run(jlaunch.main, argv + ["--steps", "4", "--ckpt-dir",
                                          str(tmp_path / "ref")])
    assert [_shape(x) for x in got] == [_shape(x) for x in want]
    losses = [float(m.group(1)) for m in
              (re.search(r"loss=(\d+\.\d+)", x) for x in got) if m]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert tckpt.CheckpointManager(str(tmp_path / "port")).all_steps() == \
        [2, 4]
    rerun = _run(tlaunch.main, argv + ["--steps", "6", "--device", "cpu",
                                       "--ckpt-dir", str(tmp_path / "port")])
    assert rerun[1] == "[train] resumed from step 4"


def test_reference_launcher_cannot_donate_a_bf16_models_float32_leaves(
        tmp_path):
    """Queue C, C3: the reference's ``init_opt_state`` keeps a float32
    leaf's master as the parameter's own buffer (``astype`` to its own
    dtype is a no-op), so its launcher's donated step gets one buffer
    twice.  The port's master is a copy."""
    with pytest.raises(jax.errors.JaxRuntimeError,
                       match="donate the same buffer twice"):
        _run(jlaunch.main, ["--arch", "mamba2_780m", "--reduced", "--batch",
                            "2", "--seq", "8", "--steps", "1"])
    cfg = _cfg("mamba2_780m", "bfloat16")
    state = _fresh(cfg, tts.TrainConfig())
    a_log = state["params"]["layers"][0]["mamba"]["a_log"]
    master = state["opt"]["master"]["layers"][0]["mamba"]["a_log"]
    assert a_log.dtype == master.dtype == torch.float32
    assert torch.equal(a_log, master)
    assert a_log.data_ptr() != master.data_ptr()
