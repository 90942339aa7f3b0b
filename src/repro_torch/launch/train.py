"""End-to-end training launcher with fault tolerance (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch olmo_1b --reduced --steps 200 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/ckpt --ckpt-every 50 [--device cpu]

The model and its state live whole on one device: the card unless
``--device cpu``.  What it exercises:
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

``--tp`` above 1 is refused: tensor parallelism needs several cards,
and the state lives whole on one device (the parameter partition rules,
``launch/sharding.py``, place it on a ``DeviceMesh`` for the dry run).
"""
from __future__ import annotations

import argparse
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
from ..models.model import init_model
from ..train.optimizer import OptConfig
from ..train.train_step import TrainConfig, init_train_state, make_train_step
from .mesh import make_host_mesh
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

    if args.tp != 1:
        raise NotImplementedError(
            f"--tp {args.tp}: tensor parallelism above 1 needs several "
            "cards (the reference's make_host_mesh(data=1, model=2) fails "
            "on one device as well); the state lives whole on one device, "
            "and the sharding rules of ROADMAP queue A, item 15, step 4 "
            "place it only for the dry run")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_host_mesh(data=args.dp, model=args.tp, device=device)
    print(f"[train] arch={cfg.name} params~{cfg.n_params/1e6:.1f}M "
          f"mesh={dict(mesh.shape)} devices={len(set(mesh.devices))}")

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

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    pipe_state = {"step": 0, "seed": args.seed}
    if mgr is not None and mgr.latest_step() is not None:
        restored, manifest = mgr.restore(state)
        if restored is not None:
            state = restored
            pipe_state = manifest.get("pipeline", pipe_state)
            print(f"[train] resumed from step {manifest['step']}")

    pipe = SyntheticLM(cfg.vocab, args.batch, args.seq, seed=args.seed)
    pipe.load_state_dict(pipe_state)
    # the pipeline's position as the loop consumes it (the prefetch
    # thread runs ahead of it)
    consumed = dict(pipe.state_dict())
    data = Prefetcher(pipe, depth=2)

    step_fn = make_train_step(cfg, tcfg)
    specs = train_batch_specs(cfg, ShapeConfig("train", args.seq, args.batch,
                                               "train"))

    if preempted["flag"]:
        print("[train] preempted during init; nothing to save; exiting")
        data.close()
        return 0

    def save(step, blocking=False):
        if mgr is None:
            return
        mgr.save(step, state,
                 extra={"pipeline": dict(consumed),
                        "mesh": dict(mesh.shape), "arch": cfg.name},
                 blocking=blocking)

    ewma = None
    start_step = int(state["step"])
    t_loop = time.time()
    for step in range(start_step, args.steps):
        t0 = time.time()
        host_batch = next(data)
        consumed["step"] += 1
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in host_batch.items()}
        batch.update(stub_embeddings(
            specs, np.random.default_rng((args.seed, step)), device))
        state, metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step={step} loss={m['loss']:.4f} "
                  f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.3f}")
        dt = time.time() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > args.straggler_factor * ewma and step > start_step + 5:
            print(f"[train] STRAGGLER step={step}: {dt:.3f}s vs ewma {ewma:.3f}s")
        if mgr is not None and step > 0 and step % args.ckpt_every == 0:
            save(step)
        if preempted["flag"]:
            save(step, blocking=True)
            print(f"[train] preempted at step {step}; state saved; exiting")
            data.close()
            return 0
    total = time.time() - t_loop
    print(f"[train] done {args.steps - start_step} steps in {total:.1f}s "
          f"({(args.steps - start_step) / max(total, 1e-9):.2f} it/s)")
    save(args.steps, blocking=True)
    data.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
