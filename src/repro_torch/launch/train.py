"""End-to-end training launcher with fault tolerance (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch olmo_1b --reduced --steps 200 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/ckpt --ckpt-every 50 [--device cpu]

One process with no rank environment keeps the model and its state
whole on one device: the card unless ``--device cpu``.  Under
``python -m torch.distributed.run --nproc-per-node D*T`` (or any
launcher that sets ``RANK``/``WORLD_SIZE``), ``--dp D --tp T`` runs on a
``(data, model)`` rank mesh of ``D*T`` ranks, one process a shard
(``launch/ranks.py``): the state placed by the sharding rules
(``launch/sharding.py``: FSDP over ``data``, tensor parallel over
``model``), each rank's batch rows over ``data``, the MoE dispatch on
each data shard's tokens, checkpoints gathered whole and restored onto
whatever mesh the resumed job has::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch olmo_1b --reduced \
        --dp 2 --tp 2 --device cpu --steps 6 --ckpt-dir /tmp/ckpt

What it exercises:
  * automatic resume from the latest valid checkpoint, the data
    pipeline's position included: the position of the next batch the
    loop consumes (the reference saves the prefetch thread's own
    position, up to ``depth + 1`` batches ahead, so its resume skips
    batches; ROADMAP queue C),
  * SIGTERM/SIGINT preemption hook -> blocking checkpoint -> clean exit,
  * async checkpointing off the training thread,
  * straggler watchdog: per-step wall time EWMA; steps slower than
    ``straggler_factor`` x EWMA are logged with their step index,
  * deterministic, checkpointable data pipeline with host prefetch,
  * for ``encdec`` and ``vlm``, the stub frontends' embeddings added to
    each batch: shaped by ``launch/specs.py``'s ``train_batch_specs``,
    standard normal draws seeded by ``(seed, step)``, so a resumed run
    sees the embeddings an uninterrupted one does (the reference's
    launcher feeds the model ``SyntheticLM``'s tokens and labels only,
    and cannot train these families: ROADMAP queue C, C4).

``--dp D --tp T`` with ``D*T`` above 1 and no rank environment is
refused: the ranks are processes, started by the launcher above.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs import get_config
from ..data.pipeline import Prefetcher, SyntheticLM
from ..kernels.common import resolve_device
from ..models.config import ShapeConfig
from ..models import runtime_flags
from ..models.model import init_model
from ..train.optimizer import OptConfig
from ..train.train_step import TrainConfig, init_train_state, make_train_step
from .mesh import axis_names, init_ranks, make_host_mesh
from .ranks import close_ranks, rank0_print
from .sharding import place_on_mesh
from .specs import stub_embeddings, train_batch_specs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    # ---- preemption hook FIRST: a SIGTERM during init must still exit
    # cleanly (there is just nothing to checkpoint yet).
    preempted = {"flag": False}

    def _on_term(sig, frame):
        preempted["flag"] = True
        print(f"[train] signal {sig}: checkpoint-and-exit requested")

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    ranked = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if not ranked and args.tp * (args.dp or 1) != 1:
        raise NotImplementedError(
            f"--dp {args.dp} --tp {args.tp}: a mesh of more than one "
            "shard runs one process a shard (ROADMAP queue A, item 15, "
            "step 4, and A16); start the ranks with python -m "
            "torch.distributed.run --nproc-per-node "
            f"{args.tp * (args.dp or 1)} -m repro_torch.launch.train ...")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if ranked:
        info = init_ranks(args.device)
        device = info.device
        mesh = make_host_mesh(data=args.dp, model=args.tp)
        runtime_flags.set_moe_mesh(mesh, ("data",))
        shape = dict(zip(axis_names(mesh), mesh.shape))
        say = rank0_print(info)
        say(f"[train] ranks={info.world} backend={info.backend} "
            f"device={device}")
    else:
        device = resolve_device(args.device)
        mesh = make_host_mesh(data=args.dp, model=args.tp, device=device)
        shape = dict(mesh.shape)
        say = print
    say(f"[train] arch={cfg.name} params~{cfg.n_params/1e6:.1f}M "
        f"mesh={shape} devices={1 if ranked else len(set(mesh.devices))}")

    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=args.warmup,
                      total_steps=args.steps),
        microbatches=args.microbatches,
        compress_grads=True,
        kv_chunk=min(1024, args.seq),
    )

    # ---- init (or resume: the checkpoint is copied into this state)
    params = init_model(cfg, seed=args.seed, device=device)
    state = init_train_state(params, tcfg)
    if ranked:  # every rank draws the same state and keeps its shards
        state = place_on_mesh(mesh, state)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    pipe_state = {"step": 0, "seed": args.seed}
    if mgr is not None and mgr.latest_step() is not None:
        restored, manifest = mgr.restore(state)
        if restored is not None:
            state = restored
            pipe_state = manifest.get("pipeline", pipe_state)
            say(f"[train] resumed from step {manifest['step']}")

    pipe = SyntheticLM(cfg.vocab, args.batch, args.seq, seed=args.seed)
    pipe.load_state_dict(pipe_state)
    # the pipeline's position as the loop consumes it (the prefetch
    # thread runs ahead of it)
    consumed = dict(pipe.state_dict())
    data = Prefetcher(pipe, depth=2)

    step_fn = make_train_step(cfg, tcfg)
    specs = train_batch_specs(cfg, ShapeConfig("train", args.seq, args.batch,
                                               "train"))

    def stop() -> bool:
        """The preemption flag, the same on every rank (a signal may
        reach one rank only; the ranks then save and exit together)."""
        if not ranked:
            return preempted["flag"]
        flag = torch.tensor([int(preempted["flag"])], device=device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

    def finish(code=0):
        data.close()
        if ranked:
            runtime_flags.set_moe_mesh(None)
            close_ranks()
        return code

    if stop():
        say("[train] preempted during init; nothing to save; exiting")
        return finish()

    def save(step, blocking=False):
        if mgr is None:
            return
        mgr.save(step, state,
                 extra={"pipeline": dict(consumed),
                        "mesh": shape, "arch": cfg.name},
                 blocking=blocking)

    ewma = None
    start_step = int(_whole(state["step"]))
    t_loop = time.time()
    for step in range(start_step, args.steps):
        t0 = time.time()
        host_batch = next(data)
        consumed["step"] += 1
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in host_batch.items()}
        batch.update(stub_embeddings(
            specs, np.random.default_rng((args.seed, step)), device))
        if ranked:  # each rank keeps its rows of the batch
            batch = place_on_mesh(mesh, batch, batch=args.batch)
        state, metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(_whole(v)) for k, v in metrics.items()}
            say(f"[train] step={step} loss={m['loss']:.4f} "
                f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.3f}")
        dt = time.time() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > args.straggler_factor * ewma and step > start_step + 5:
            print(f"[train] STRAGGLER step={step}: {dt:.3f}s vs ewma {ewma:.3f}s")
        if mgr is not None and step > 0 and step % args.ckpt_every == 0:
            save(step)
        if stop():
            save(step, blocking=True)
            say(f"[train] preempted at step {step}; state saved; exiting")
            return finish()
    total = time.time() - t_loop
    say(f"[train] done {args.steps - start_step} steps in {total:.1f}s "
        f"({(args.steps - start_step) / max(total, 1e-9):.2f} it/s)")
    save(args.steps, blocking=True)
    return finish()


def _whole(t):
    """A metric or counter as one tensor: a DTensor's whole value."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


if __name__ == "__main__":
    sys.exit(main())
