"""The LM stack across ranks: a real ``(data, model)`` mesh of ``gloo`` ranks.

Counterparts of the reference's sharded LM checks
(``tests/test_distributed.py``: the train step on ``make_host_mesh(data=4,
model=2)``, the sharded loss against the one-device loss, the MoE
dispatch on ``(2, 4)``), on eight CPU ranks started once for the module
(:func:`repro_torch.launch.ranks.spawn_ranks`), each holding its shards
of DTensors placed by the sharding rules
(:func:`repro_torch.launch.sharding.place_on_mesh`).  The weights are the
reference's, carried across (``params_from_numpy``).  Then the launcher:
``--dp 2 --tp 2`` for three steps, resumed with ``--dp 4 --tp 1`` to six
(the checkpoint gathered whole, restored onto the new mesh), against an
uninterrupted run in one process.
"""
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import init_model, loss_fn
from repro.models.moe import init_moe, moe_ffn
from repro_torch.launch.ranks import spawn_ranks

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS_TIMEOUT_S = 300
STEP_LINE = re.compile(r"^\[train\] step=(\d+) loss=(\d+\.\d{4}) ")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _flat(tree, prefix=""):
    """A nested dict of arrays as ``{"a/b": array}`` (``np.savez``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


_CHILD = """
    import sys
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_ranks, make_host_mesh
    from repro_torch.launch.sharding import place_on_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.models.model import loss_fn, params_from_numpy
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.shards import replicating
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    def tree(path):
        import ml_dtypes  # np.savez keeps bfloat16 as 2-byte voids

        out = {}
        with np.load(path) as z:
            for k in z.files:
                *nodes, leaf = k.split("/")
                d = out
                for n in nodes:
                    d = d.setdefault(n, {})
                a = z[k]
                d[leaf] = a.view(ml_dtypes.bfloat16) if a.dtype.kind == "V" \
                    else a
        return out

    info = init_ranks(device="cpu")
    d = sys.argv[1]
    out = {"backend": np.array(info.backend)}

    # the train step on (4, 2): the loss falls over six steps
    cfg = get_config("olmo_1b").reduced(n_layers=2, d_model=64, n_heads=4,
                                        n_kv_heads=4, d_ff=128, vocab=256)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0),
                       microbatches=2, kv_chunk=8)
    mesh = make_host_mesh(data=4, model=2)
    state = place_on_mesh(mesh, init_train_state(params_from_numpy(
        tree(d + "/train.npz"), cfg, device="cpu"), tcfg))
    b = np.load(d + "/train_batch.npz")
    batch = place_on_mesh(mesh, {k: torch.from_numpy(b[k])
                                 for k in ("tokens", "labels")}, batch=8)
    step = make_train_step(cfg, tcfg)
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"].full_tensor()))
    out["train_losses"] = np.array(losses)
    out["train_local"] = np.array(state["params"]["embed"]["embedding"]
                                  .to_local().shape)

    # the loss on (4, 2) against the one-device loss
    cfg = get_config("qwen3_0_6b").reduced(n_layers=2, dtype="float32")
    params = place_on_mesh(mesh, params_from_numpy(
        tree(d + "/loss.npz"), cfg, device="cpu"))
    b = np.load(d + "/loss_batch.npz")
    batch = place_on_mesh(mesh, {k: torch.from_numpy(b[k])
                                 for k in ("tokens", "labels")}, batch=4)
    with torch.no_grad(), replicating(batch["tokens"]):
        out["loss"] = np.array(float(loss_fn(params, batch, cfg,
                                             kv_chunk=8).full_tensor()))

    # the MoE dispatch on (2, 4)
    cfg = get_config("olmoe_1b_7b").reduced(d_model=64, dtype="float32")
    mesh = make_host_mesh(data=2, model=4)
    moe = place_on_mesh(mesh, tmodel._node(tree(d + "/moe.npz"), "cpu"))
    x = place_on_mesh(mesh, {"x": torch.from_numpy(
        np.load(d + "/moe_x.npy"))}, batch=4)["x"]
    with torch.no_grad(), replicating(x):
        y, aux = moe_ffn(moe, x, cfg)
    out["moe_y"] = y.full_tensor().numpy()

    # the dispatch on each data shard's tokens (the train step's): the
    # router's and the experts' gradients on the mesh against one
    # process with two token groups; then again with the plain
    # collectives in place of DTensor's functional ones (what init_ranks
    # installs on a gloo group of CUDA ranks), here on CPU tensors
    from repro_torch.launch.ranks import sync_functional_collectives
    from repro_torch.models import runtime_flags

    names = ("router", "gate_ein", "up_ein", "down_eout")

    def grads(params, x):
        leaves = [params[k].detach().requires_grad_() for k in names]
        p = dict(zip(names, leaves))
        with replicating(x):
            y, aux = moe_ffn(p, x, cfg)
            loss = (y * y).sum() + aux
        return [g.full_tensor() if hasattr(g, "full_tensor") else g
                for g in torch.autograd.grad(loss, leaves)]

    plain = tmodel._node(tree(d + "/moe.npz"), "cpu")
    runtime_flags.set_moe_groups(2)
    want = grads(plain, torch.from_numpy(np.load(d + "/moe_x.npy")))
    runtime_flags.set_moe_groups(1)
    runtime_flags.set_moe_mesh(mesh, ("data",))
    got = grads(moe, x)
    sync_functional_collectives("CPU")
    again = grads(moe, x)
    runtime_flags.set_moe_mesh(None)
    out["moe_grad_rel_err"] = np.array(max(
        float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)))
    out["moe_grad_sync_equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(got, again)))
    np.savez(d + "/out%d.npz" % info.rank, **out)
    dist.barrier()
    print(info.describe())
"""


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """The reference's weights and one-device answers, and the eight
    ranks' answers: ``(ref, {rank: arrays})``."""
    d = tmp_path_factory.mktemp("ranks_lm")
    ref = {}
    cfg = get_config("olmo_1b").reduced(n_layers=2, d_model=64, n_heads=4,
                                        n_kv_heads=4, d_ff=128, vocab=256)
    np.savez(d / "train.npz", **_flat(init_model(jax.random.key(0), cfg)))
    rng = np.random.default_rng(0)
    np.savez(d / "train_batch.npz",
             tokens=rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32),
             labels=rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32))
    cfg = get_config("qwen3_0_6b").reduced(n_layers=2, dtype="float32")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)}
    params = init_model(jax.random.key(1), cfg)
    ref["loss"] = float(loss_fn(params, batch, cfg, kv_chunk=8))
    np.savez(d / "loss.npz", **_flat(params))
    np.savez(d / "loss_batch.npz", **batch)
    cfg = get_config("olmoe_1b_7b").reduced(d_model=64, dtype="float32")
    params = init_moe(jax.random.key(0), cfg)
    x = np.random.default_rng(0).normal(size=(4, 8, 64)).astype(np.float32)
    ref["moe_y"] = np.asarray(moe_ffn(params, jnp.asarray(x), cfg)[0])
    np.savez(d / "moe.npz", **_flat(params))
    np.save(d / "moe_x.npy", x)
    res = spawn_ranks([sys.executable, "-c", textwrap.dedent(_CHILD),
                       str(d)], 8, timeout_s=RANKS_TIMEOUT_S, env=_env(),
                      rendezvous=str(d / "rendezvous"))
    for r, (_, so, _) in enumerate(res):
        assert so.strip().endswith(f"rank {r} of 8 on cpu (gloo)"), so
    return ref, {r: dict(np.load(d / f"out{r}.npz")) for r in range(8)}


def test_train_step_on_a_data_model_mesh_lowers_the_loss(eight_ranks):
    """The reference's ``test_sharded_train_step_runs_dp_tp``."""
    _, ranks = eight_ranks
    for r in range(8):
        losses = ranks[r]["train_losses"]
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
        np.testing.assert_array_equal(losses, ranks[0]["train_losses"])
        # the embedding [256, 64]: vocab over "model" (2), rows whole
        assert list(ranks[r]["train_local"]) == [128, 64]
        assert str(ranks[r]["backend"]) == "gloo"


def test_sharded_loss_equals_the_one_device_loss(eight_ranks):
    """The reference's ``test_sharded_equals_single_device`` (its bar is
    1e-3; float32 across ranks holds 1e-4)."""
    ref, ranks = eight_ranks
    for r in range(8):
        assert abs(float(ranks[r]["loss"]) - ref["loss"]) < 1e-4


def test_moe_dispatch_under_sharding(eight_ranks):
    """The reference's ``test_moe_dispatch_under_sharding`` on (2, 4)."""
    ref, ranks = eight_ranks
    for r in range(8):
        assert np.abs(ranks[r]["moe_y"] - ref["moe_y"]).max() < 1e-4


def test_moe_gradients_on_the_mesh_and_through_plain_collectives(
        eight_ranks):
    """The dispatch on each data shard's tokens: the router's and the
    experts' gradients are each rank's share of a sum (``Partial``) and
    reduce to the one-process gradients of two token groups; the plain
    collectives that stand in for DTensor's functional ones on a gloo
    group of CUDA ranks give the same gradients bit for bit."""
    _, ranks = eight_ranks
    for r in range(8):
        assert float(ranks[r]["moe_grad_rel_err"]) < 1e-5
        assert bool(ranks[r]["moe_grad_sync_equal"])


# ---------------------------------------------------------------------------
# the launcher: --dp 2 --tp 2, resumed on --dp 4 --tp 1
# ---------------------------------------------------------------------------
ARGS = ("--arch", "olmo_1b", "--reduced", "--device", "cpu", "--batch",
        "4", "--seq", "16", "--log-every", "1", "--ckpt-every", "100")
#: the launcher with its config in float32, which holds runs on different
#: meshes to float32 rounding: ``train.main`` with ``get_config`` wrapped
_F32_LAUNCHER = """
import dataclasses, sys
from repro_torch.launch import train
_get = train.get_config
train.get_config = lambda arch: dataclasses.replace(_get(arch),
                                                    dtype="float32")
sys.exit(train.main(sys.argv[1:]))
"""


def _launch(tmp, tag, world, *args):
    argv = [sys.executable, "-c", _F32_LAUNCHER, *ARGS, *args]
    if world == 1:
        out = subprocess.run(argv, env=_env(), capture_output=True,
                             text=True, timeout=RANKS_TIMEOUT_S)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout.splitlines()
    res = spawn_ranks(argv, world, timeout_s=RANKS_TIMEOUT_S, env=_env(),
                      rendezvous=str(tmp / f"rendezvous_{tag}"))
    for _, so, _ in res[1:]:
        assert not so.strip(), so  # only rank 0 reports
    return res[0][1].splitlines()


def _losses(lines) -> dict:
    return {int(m.group(1)): float(m.group(2))
            for m in map(STEP_LINE.match, lines) if m}


def test_launcher_trains_on_ranks_and_resumes_on_another_mesh(tmp_path):
    from repro_torch.ckpt.checkpoint import CheckpointManager

    first = _launch(tmp_path, "a", 4, "--dp", "2", "--tp", "2", "--steps",
                    "3", "--ckpt-dir", str(tmp_path / "a"))
    assert first[0] == "[train] ranks=4 backend=gloo device=cpu"
    assert "mesh={'data': 2, 'model': 2}" in first[1]
    second = _launch(tmp_path, "b", 4, "--dp", "4", "--tp", "1", "--steps",
                     "6", "--ckpt-dir", str(tmp_path / "a"))
    assert "mesh={'data': 4, 'model': 1}" in second[1]
    assert second[2] == "[train] resumed from step 3"
    whole = _launch(tmp_path, "c", 1, "--steps", "6", "--ckpt-dir",
                    str(tmp_path / "b"))
    assert "mesh={'data': 1, 'model': 1} devices=1" in whole[0]
    got, want = {**_losses(first), **_losses(second)}, _losses(whole)
    assert sorted(got) == sorted(want) == list(range(6))
    for s in want:
        assert abs(got[s] - want[s]) <= 1e-5 * want[s], s
    a = CheckpointManager(str(tmp_path / "a"))
    b = CheckpointManager(str(tmp_path / "b"))
    assert a.all_steps() == [3, 6] and b.all_steps() == [6]
    with np.load(tmp_path / "a" / "step_0000000006" / "arrays.npz") as za, \
            np.load(tmp_path / "b" / "step_0000000006" / "arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if k.startswith(("params/", "opt/master/")):
                assert np.abs(za[k] - zb[k]).max() <= 1e-5, k


def test_launcher_refuses_a_mesh_without_ranks(tmp_path):
    """One process with no rank environment keeps one device."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *ARGS, "--dp", "2", "--steps", "1"], env=_env(),
                         capture_output=True, text=True,
                         timeout=RANKS_TIMEOUT_S)
    assert out.returncode != 0
    assert "torch.distributed.run --nproc-per-node 2" in out.stderr
