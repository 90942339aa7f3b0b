"""The port's checkpoints and training launcher, on the CPU.

Checkpoints are held against the reference's ``CheckpointManager`` in
both directions: a checkpoint of a reduced train state that either
package writes restores bit for bit in the other (the on-disk format,
leaf names, dtype strings and manifest are the reference's).  The
launcher is run in-process (resume) and as a child process (its
``__main__``, and SIGTERM mid-loop), at ``--reduced --device cpu``.
"""
import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.models import model as jmodel
from repro.train import train_step as jts
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models.layers import stacked_leaves, tree_leaves
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _named(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _bits(a: np.ndarray) -> tuple:
    """dtype-free bits of a leaf: bfloat16 through float32 (exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a.shape, a.tobytes()


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    arrs = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


@pytest.fixture(scope="module")
def reduced_moe():
    """A reduced bf16 OLMoE train state after one step of the reference
    (mu, nu and ef non-zero) and the port's own after one step."""
    cfg = jax_get_config("olmoe_1b_7b").reduced()
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


def _fresh(cfg, tcfg, seed=9):
    return tts.init_train_state(tmodel.init_model(cfg, seed=seed,
                                                  device="cpu"), tcfg)


def test_reference_checkpoint_restores_into_the_port(reduced_moe, tmp_path):
    cfg, tcfg, jstate, _ = reduced_moe
    jckpt.CheckpointManager(str(tmp_path)).save(
        7, jstate, extra={"pipeline": {"step": 7, "seed": 0}},
        blocking=True)
    template = _fresh(cfg, tcfg)
    before = {n: [id(t) for t in parts]
              for n, parts, _ in stacked_leaves(template)}
    mgr = tckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7
    restored, manifest = mgr.restore(template)
    assert restored is template  # copied in place
    assert {n: [id(t) for t in parts]
            for n, parts, _ in stacked_leaves(restored)} == before
    assert manifest["step"] == 7 and manifest["pipeline"]["step"] == 7
    assert template["params"]["embed"]["embedding"].dtype == torch.bfloat16
    want = _named(jax.tree.map(np.asarray, jstate))
    got = _named(tts.train_state_to_numpy(restored))
    assert set(got) == set(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def test_port_checkpoint_restores_into_the_reference(reduced_moe, tmp_path):
    cfg, tcfg, jstate, state = reduced_moe
    tckpt.CheckpointManager(str(tmp_path)).save(
        3, state, extra={"pipeline": {"step": 3, "seed": 0}, "arch": "x"},
        blocking=True)
    path = tmp_path / "step_0000000003"
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    manifest = json.loads((path / "manifest.json").read_text())
    assert set(manifest) == {"step", "time", "leaves", "dtypes", "pipeline",
                             "arch"}
    # the reference's own manifest of a state of this structure
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(3, jstate,
                                                        blocking=True)
    ref_manifest = json.loads(
        (tmp_path / "ref" / "step_0000000003" / "manifest.json").read_text())
    assert manifest["leaves"] == ref_manifest["leaves"]
    assert manifest["dtypes"] == ref_manifest["dtypes"]
    assert manifest["dtypes"]["params/embed/embedding"] == "bfloat16"
    assert manifest["dtypes"]["params/layers/moe/router"] == "float32"
    assert manifest["dtypes"]["step"] == "int32"

    tpl = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jstate)
    restored, m = jckpt.CheckpointManager(str(tmp_path)).restore(tpl)
    assert m["step"] == 3
    want = _named(tts.train_state_to_numpy(state))
    got = _named(jax.tree.map(np.asarray, restored))
    assert set(got) == set(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k
    assert got["params/embed/embedding"].dtype.name == "bfloat16"


def test_save_snapshots_before_returning(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    x = torch.arange(4.0)
    mgr.save(1, {"x": x})
    x.add_(10)  # after the call: not in the checkpoint
    mgr.wait()
    out, _ = mgr.restore({"x": torch.zeros(4)})
    assert torch.equal(out["x"], torch.arange(4.0))


def test_checkpoint_keeps_last_k(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.arange(4.0) + s}, blocking=True)
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]


def test_checkpoint_atomic_on_partial_write(tmp_path):
    """A stray tmp dir (crashed writer) is not picked up."""
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(5, {"x": torch.arange(4.0)}, blocking=True)
    os.makedirs(tmp_path / "tmp.9", exist_ok=True)  # simulated crash
    (tmp_path / "tmp.9" / "arrays.npz").write_bytes(b"garbage")
    os.makedirs(tmp_path / "step_0000000011")  # no manifest: torn
    assert mgr.latest_step() == 5
    out, m = mgr.restore({"x": torch.zeros(4)})
    assert m["step"] == 5 and torch.equal(out["x"], torch.arange(4.0))


def test_only_process_zero_writes(tmp_path):
    tckpt.CheckpointManager(str(tmp_path), process_index=1).save(
        1, {"x": torch.arange(4.0)}, blocking=True)
    assert os.listdir(tmp_path) == []
    assert tckpt.CheckpointManager(str(tmp_path)).proc == 0


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_restore_errors_match_reference(fault, tmp_path):
    state = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
             "b": np.zeros(2, np.int32)}
    jckpt.CheckpointManager(str(tmp_path)).save(1, state, blocking=True)
    if fault == "missing":
        jtpl = {**state, "c": np.zeros(1, np.float32)}
        ttpl = {"a": {"w": torch.zeros(2, 3)}, "b": torch.zeros(2),
                "c": torch.zeros(1)}
        err = KeyError
    else:
        jtpl = {**state, "b": np.zeros(3, np.int32)}
        ttpl = {"a": {"w": torch.zeros(2, 3)}, "b": torch.zeros(3)}
        err = ValueError
    with pytest.raises(err) as want:
        jckpt.CheckpointManager(str(tmp_path)).restore(jtpl)
    keep = torch.zeros(2, 3)
    ttpl["a"]["w"] = keep
    with pytest.raises(err) as got:
        tckpt.CheckpointManager(str(tmp_path)).restore(ttpl)
    assert str(got.value) == str(want.value)
    assert torch.equal(keep, torch.zeros(2, 3))  # nothing written


def test_train_checkpoint_resume_cycle(tmp_path):
    """Train 5 steps, checkpoint, resume, continue: the reference's
    ``test_train_checkpoint_resume_cycle`` on the port."""
    cfg = get_config("olmo_1b").reduced(n_layers=1)
    tcfg = tts.TrainConfig(opt=topt.OptConfig(lr=1e-3, warmup_steps=0),
                           microbatches=1, kv_chunk=8)
    _, batch = _batch(cfg, 2, 16, seed=3)
    step = tts.make_train_step(cfg, tcfg)
    state = _fresh(cfg, tcfg, seed=0)
    for _ in range(5):
        state, m = step(state, batch)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(5, state, blocking=True)
    state, m6 = step(state, batch)  # step 6 from the live state
    restored, _ = mgr.restore(_fresh(cfg, tcfg, seed=0))
    _, m6b = step(restored, batch)
    assert abs(float(m6["loss"]) - float(m6b["loss"])) < 1e-5
    assert float(m6["loss"]) == float(m6b["loss"])  # one device: exact


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.fixture
def run_main():
    """``launch.train.main`` in-process; its signal handlers restored."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}

    def run(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tlaunch.main(list(argv))
        return rc, out.getvalue().splitlines()

    yield run
    for s, h in saved.items():
        signal.signal(s, h)


ARGS = ("--arch", "olmo_1b", "--reduced", "--device", "cpu", "--batch", "2",
        "--seq", "32", "--log-every", "1", "--ckpt-every", "3")
STEP_LINE = re.compile(r"^\[train\] step=(\d+) loss=(\d+\.\d{4}) "
                       r"lr=(\d\.\d\de[-+]\d\d) gnorm=(\d+\.\d{3})$")


def _losses(lines) -> dict:
    return {int(m.group(1)): float(m.group(2))
            for m in map(STEP_LINE.match, lines) if m}


def test_launcher_resumes_where_it_stopped(run_main, tmp_path):
    rc, first = run_main(*ARGS, "--steps", "6", "--ckpt-dir",
                         str(tmp_path / "a"))
    assert rc == 0
    assert re.match(r"^\[train\] arch=olmo-1b params~\d+\.\dM "
                    r"mesh=\{'data': 1, 'model': 1\} devices=1$", first[0])
    assert sorted(_losses(first)) == list(range(6))
    assert re.match(r"^\[train\] done 6 steps in \d+\.\ds \(\d+\.\d\d it/s\)$",
                    first[-1])
    mgr = tckpt.CheckpointManager(str(tmp_path / "a"))
    assert mgr.all_steps() == [3, 6]
    rc, second = run_main(*ARGS, "--steps", "9", "--ckpt-dir",
                          str(tmp_path / "a"))
    assert rc == 0 and second[1] == "[train] resumed from step 6"
    assert sorted(_losses(second)) == [6, 7, 8]
    manifest = json.loads((tmp_path / "a" / "step_0000000009" /
                           "manifest.json").read_text())
    # the pipeline's position as consumed: nine batches
    assert manifest["pipeline"] == {"step": 9, "seed": 0}
    assert manifest["arch"] == "olmo-1b"
    rc, whole = run_main(*ARGS, "--steps", "9", "--ckpt-dir",
                         str(tmp_path / "b"))
    assert rc == 0
    want, got = _losses(whole), {**_losses(first), **_losses(second)}
    assert sorted(got) == sorted(want) == list(range(9))
    for s in want:
        assert abs(got[s] - want[s]) <= 1e-5 * want[s], s


def test_launcher_refuses_tensor_parallel(run_main):
    with pytest.raises(NotImplementedError, match="step 4"):
        run_main(*ARGS, "--steps", "1", "--tp", "2")


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_launcher_main_prints_the_reference_lines(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
         "--steps", "4", "--ckpt-dir", str(tmp_path)],
        env=_child_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-800:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[train] arch=olmo-1b params~")
    assert sorted(_losses(lines)) == [0, 1, 2, 3]
    assert lines[-1].startswith("[train] done 4 steps in ")
    assert tckpt.CheckpointManager(str(tmp_path)).all_steps() == [3, 4]


def test_launcher_preemption_hook(tmp_path):
    """SIGTERM mid-training checkpoints and exits 0 (the reference's
    ``test_train_launcher_preemption_hook``)."""
    logf = tmp_path / "out.log"
    with open(logf, "w") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "repro_torch.launch.train",
             "--arch", "olmo_1b", "--reduced", "--device", "cpu",
             "--steps", "100000", "--batch", "2", "--seq", "32",
             "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "10"],
            env=_child_env(), stdout=lf, stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.time() + 240
            while "step=10 " not in logf.read_text():
                assert proc.poll() is None, logf.read_text()[-800:]
                assert time.time() < deadline, "the loop never reached 10"
                time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = logf.read_text()
    assert proc.returncode == 0, out[-800:]
    assert "preempted at step" in out and "state saved" in out
    step = int(re.search(r"preempted at step (\d+)", out).group(1))
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() == step >= 10
    cfg = get_config("olmo_1b").reduced()
    restored, manifest = mgr.restore(_fresh(cfg, tts.TrainConfig()))
    assert int(restored["step"]) == step + 1
    assert manifest["pipeline"]["step"] == step + 1
    assert all(torch.isfinite(t).all() for t in tree_leaves(
        restored["params"]))
