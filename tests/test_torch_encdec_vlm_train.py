"""The port's training path on the ``encdec`` (Seamless-M4T-medium) and
``vlm`` (Llama-3.2-Vision-11B) families against the JAX package, on the
CPU, at reduced sizes: ``loss_fn`` and its gradients on batches that
carry the stub embeddings, activation checkpointing, one train step, the
train state and its checkpoints both ways, and the training launcher,
which adds the embeddings the reference's launcher cannot (ROADMAP
queue C, C4).

Tolerances as in ``test_torch_train``, relative to each leaf's largest
magnitude: float32 ``F32_RTOL = 1e-5`` (measured about 1e-6), bfloat16
``loss_fn`` ``BF16_RTOL = 4e-2``; a train step's parameters move within
``2 lr`` of the reference's, and within ``TIGHT * lr`` where the clipped
gradient's trace ``|mu|`` is clear of 0.
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
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import runtime_flags as tflags
from repro_torch.models.config import ShapeConfig
from repro_torch.models.layers import stacked_leaves, tree_leaves, \
    tree_unflatten
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

torch.set_num_threads(1)

F32_RTOL = 1e-5
BF16_RTOL = 4e-2
TIGHT = 1e-3
ARCHS = ("seamless_m4t_medium", "llama_3_2_vision_11b")


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
    if arch == "llama_3_2_vision_11b":
        kw = {"n_layers": 4, "n_vision_tokens": 13, **kw}
    return get_config(arch).reduced(dtype=dtype, **kw)


def _batch(cfg, B, S, seed, ignore=0):
    """Tokens, labels and the family's stub embeddings (a source of
    ``S - 3`` positions for encdec), the same for both packages."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab[0, :ignore] = -1
    key, n = {"encdec": ("src_embeds", S - 3),
              "vlm": ("vision_embeds", cfg.n_vision_tokens)}[cfg.family]
    emb = rng.normal(size=(B, n, cfg.d_model))
    dt = jnp.dtype(cfg.dtype)
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
             key: jnp.asarray(emb, dt)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
             key: torch.from_numpy(emb).to(getattr(torch, cfg.dtype))})


def _weights(cfg, seed=0):
    params = jmodel.init_model(jax.random.key(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype,kw,tol", [
    ("seamless_m4t_medium", "float32", {}, F32_RTOL),
    ("seamless_m4t_medium", "bfloat16", {}, BF16_RTOL),
    ("seamless_m4t_medium", "float32", {"n_enc_layers": 3}, F32_RTOL),
    ("llama_3_2_vision_11b", "float32", {}, F32_RTOL),
    ("llama_3_2_vision_11b", "bfloat16", {}, BF16_RTOL),
    ("llama_3_2_vision_11b", "float32", {"n_layers": 6}, F32_RTOL),
], ids=["seamless-f32", "seamless-bf16", "seamless-f32-enc3", "llama-f32",
        "llama-bf16", "llama-f32-L6"])
def test_loss_fn_and_gradients_match_reference(arch, dtype, kw, tol):
    """Every leaf's gradient, the encoder's and each cross block's too,
    against ``jax.grad`` of the reference's ``loss_fn``."""
    cfg = _cfg(arch, dtype, **kw)
    params, tree = _weights(cfg)
    bj, bt = _batch(cfg, 2, 12, seed=1, ignore=3)
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
    if dtype == "float32":  # every leaf takes a gradient
        assert all(np.abs(want[k]).max() > 0 for k in want), \
            [k for k in want if not np.abs(want[k]).max()]


def _counted(monkeypatch):
    """Count the blocks run: each ``_dense_block`` and each cross block."""
    calls = {"dense": 0, "cross": 0}
    dense, cross = tmodel._dense_block, tmodel._cross_block

    def counted_dense(*a, **kw):
        calls["dense"] += 1
        return dense(*a, **kw)

    def counted_cross(*a, **kw):
        calls["cross"] += 1
        return cross(*a, **kw)

    monkeypatch.setattr(tmodel, "_dense_block", counted_dense)
    monkeypatch.setattr(tmodel, "_cross_block", counted_cross)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_unchecked_blocks(policy, arch, monkeypatch):
    """Each encoder block, each decoder block with its cross block, each
    vlm block with its cross block where it fires is one checkpointed
    unit: the backward recomputes them, and the gradients are those of
    the blocks run as they are, bit for bit."""
    cfg = _cfg(arch, n_layers=4 if arch == "llama_3_2_vision_11b" else 2)
    dense = cfg.n_layers + cfg.n_enc_layers
    cross = cfg.n_layers if cfg.family == "encdec" else \
        cfg.n_layers // cfg.cross_attn_every
    p = tmodel.init_model(cfg, seed=3, device="cpu")
    _, bt = _batch(cfg, 2, 12, seed=4)
    bt = {k: v.float() if v.is_floating_point() else v for k, v in bt.items()}
    leaves = tree_leaves(p)
    calls = _counted(monkeypatch)

    monkeypatch.setattr(tflags, "REMAT", policy)
    loss = tmodel.loss_fn(p, bt, cfg, kv_chunk=8)
    got = torch.autograd.grad(loss, leaves)
    assert calls == {"dense": 2 * dense, "cross": 2 * cross}

    calls.update(dense=0, cross=0)
    with monkeypatch.context() as m:
        m.setattr(tmodel, "_ckpt", lambda fn: fn)
        want_loss = tmodel.loss_fn(p, bt, cfg, kv_chunk=8)
        want = torch.autograd.grad(want_loss, leaves)
    assert calls == {"dense": dense, "cross": cross}
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the train step and the train state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step of two microbatches with bf16 compression, from the
    reference's initial train state carried across; the stub embeddings
    split into microbatches with the tokens."""
    cfg = _cfg(arch)
    params, _ = _weights(cfg, seed=0)
    bj, bt = _batch(cfg, 4, 12, seed=0)
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


@pytest.fixture(scope="module", params=ARCHS)
def stepped_bf16(request):
    """A reduced bf16 train state of each family after one step of the
    reference (mu, nu and ef non-zero), and the port's own after one."""
    cfg = _cfg(request.param, "bfloat16")
    jcfg = jts.TrainConfig(microbatches=2, kv_chunk=8)
    tcfg = tts.TrainConfig(microbatches=2, kv_chunk=8)
    bj, bt = _batch(cfg, 4, 12, seed=1)
    jstate = jts.init_train_state(jmodel.init_model(jax.random.key(0), cfg),
                                  jcfg)
    jstate, _ = jax.jit(jts.make_train_step(cfg, jcfg))(jstate, bj)
    state = tts.init_train_state(tmodel.init_model(cfg, seed=5,
                                                   device="cpu"), tcfg)
    state, _ = tts.make_train_step(cfg, tcfg)(state, bt)
    return cfg, tcfg, jstate, state


def test_train_state_round_trips_the_reference(stepped_bf16):
    """``enc_layers``, ``dec_cross`` and ``cross`` are stacked in
    ``master``, ``mu``, ``nu`` and ``ef`` as in the parameters."""
    cfg, tcfg, jstate, _ = stepped_bf16
    tree = jax.tree.map(np.asarray, jstate)
    state = tts.train_state_from_numpy(tree, cfg, tcfg, device="cpu")
    stack = "dec_cross" if cfg.family == "encdec" else "cross"
    for k in ("master", "mu", "nu"):
        assert len(state["opt"][k][stack]) == len(state["params"][stack])
    assert state["opt"]["master"][stack][0]["attn"]["q_in"].dtype == \
        torch.float32
    want, got = _named(tree), _named(tts.train_state_to_numpy(state))
    assert set(got) == set(want)
    assert any(k.startswith(f"ef/{stack}/") for k in want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def _fresh(cfg, tcfg, seed=9):
    return tts.init_train_state(tmodel.init_model(cfg, seed=seed,
                                                  device="cpu"), tcfg)


def test_reference_checkpoint_restores_into_the_port(stepped_bf16, tmp_path):
    cfg, tcfg, jstate, _ = stepped_bf16
    jckpt.CheckpointManager(str(tmp_path)).save(4, jstate, blocking=True)
    restored, manifest = tckpt.CheckpointManager(str(tmp_path)).restore(
        _fresh(cfg, tcfg))
    assert manifest["step"] == 4
    want = _named(jax.tree.map(np.asarray, jstate))
    got = _named(tts.train_state_to_numpy(restored))
    assert set(got) == set(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def test_port_checkpoint_restores_into_the_reference(stepped_bf16, tmp_path):
    cfg, tcfg, jstate, state = stepped_bf16
    tckpt.CheckpointManager(str(tmp_path)).save(3, state, blocking=True)
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(3, jstate,
                                                        blocking=True)
    manifest, ref_manifest = (json.loads(
        (d / "step_0000000003" / "manifest.json").read_text())
        for d in (tmp_path, tmp_path / "ref"))
    assert manifest["leaves"] == ref_manifest["leaves"]
    assert manifest["dtypes"] == ref_manifest["dtypes"]
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


ARGV = ["--reduced", "--batch", "2", "--seq", "16", "--log-every", "1",
        "--ckpt-every", "3", "--device", "cpu"]


def _losses(lines) -> list:
    return [float(m.group(1)) for m in
            (re.search(r"loss=(\d+\.\d+)", x) for x in lines) if m]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_trains_and_resumes_exactly(arch, tmp_path, monkeypatch):
    """6 steps, then a second call that resumes from the step-6
    checkpoint and runs to 9, against an uninterrupted run to 9: the
    same losses and the same final state, bit for bit.  Every batch the
    step gets carries the stub embeddings of ``train_batch_specs``,
    drawn from ``(seed, step)``."""
    fed = []
    make = tlaunch.make_train_step

    def recording(cfg_, tcfg_):
        inner = make(cfg_, tcfg_)

        def run(state_, batch_):
            fed.append({k: v.clone() for k, v in batch_.items()})
            out = inner(state_, batch_)
            recording.state = out[0]
            return out
        return run

    monkeypatch.setattr(tlaunch, "make_train_step", recording)
    a = _run(tlaunch.main, ARGV + ["--arch", arch, "--steps", "6",
                                   "--ckpt-dir", str(tmp_path / "a")])
    b = _run(tlaunch.main, ARGV + ["--arch", arch, "--steps", "9",
                                   "--ckpt-dir", str(tmp_path / "a")])
    resumed_state, resumed_fed = recording.state, fed[:]
    fed.clear()
    whole = _run(tlaunch.main, ARGV + ["--arch", arch, "--steps", "9",
                                       "--ckpt-dir", str(tmp_path / "b")])
    assert b[1] == "[train] resumed from step 6"
    assert _losses(a) + _losses(b) == _losses(whole)
    assert len(_losses(whole)) == 9 and np.all(np.isfinite(_losses(whole)))
    cfg = get_config(arch).reduced()
    specs = tspecs.train_batch_specs(cfg, ShapeConfig("t", 16, 2, "train"))
    assert set(fed[0]) == set(specs)
    for k, spec in specs.items():
        assert fed[0][k].shape == spec.shape and fed[0][k].dtype == \
            spec.dtype, k
    for got, want in zip(resumed_fed, fed):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(x, y) for (_, px, _), (_, py, _) in zip(
        stacked_leaves(resumed_state), stacked_leaves(recording.state))
        for x, y in zip(px, py))
    # the embeddings of step s are the draws of (seed, s)
    emb = tspecs.stub_embeddings(specs, np.random.default_rng((0, 4)), "cpu")
    assert all(torch.equal(fed[4][k], v) for k, v in emb.items())


@pytest.mark.parametrize("arch,missing", [
    ("seamless_m4t_medium", "src_embeds"),
    ("llama_3_2_vision_11b", "vision_embeds")])
def test_reference_launcher_cannot_train_encdec_or_vlm(arch, missing,
                                                       tmp_path):
    """Queue C, C4: the reference's launcher feeds its step
    ``SyntheticLM``'s tokens and labels only, and its ``forward`` reads
    the stub embeddings from the batch.  The port's launcher adds them
    (above)."""
    with pytest.raises(KeyError, match=missing):
        _run(jlaunch.main, ["--arch", arch, "--reduced", "--batch", "2",
                            "--seq", "8", "--steps", "1"])
