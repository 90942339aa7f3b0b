"""Batched serving launcher: continuous-batching decode loop.

Counterpart of ``repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch olmoe_1b_7b --batch 4 --prompt-len 512 --gen 32 \\
        [--reduced] [--device cpu] [--plan-cache-dir DIR]

Prefill builds the KV caches, then a decode loop greedily samples one
token per step (argmax over the first ``vocab`` logits) for the whole
batch.  Requests are slotted into the fixed batch; the queue is
synthetic prompts drawn from ``--seed``, with the stub frontends'
embeddings (``encdec``: ``src_embeds`` of the prompt's length; ``vlm``:
``vision_embeds``) drawn after each batch's tokens, as the reference
draws them.  The model runs on the card unless ``--device cpu``, under
``torch.inference_mode()`` (on ranks ``torch.no_grad()``); its weights
are random, drawn from ``--seed`` on the device.

Under ``python -m torch.distributed.run`` (``WORLD_SIZE`` > 1) every
rank is one shard of a mesh over all the ranks, as the reference serves
under ``make_host_mesh()`` over every device: ``(data = world, model =
1)``.  Each rank draws the weights from ``--seed`` block by block and
keeps its shards (the layout ``launch.sharding.serving_mode`` chooses,
as the reference's dry run does for its serving cells), draws the same
prompts and keeps its rows of each batch (``--batch`` is the global
batch), and the MoE dispatch runs on each data shard's tokens.  Only
rank 0 prints; tok/s counts the global batch:

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.serve --arch olmo_1b --reduced --device cpu

The process environment is tuned at import, as the reference's launcher
does (``repro_torch.sparse.serving.runtime_env``).  ``--plan-cache-dir``
turns on the persistent plan service: the continuous-batching slot table
is assembled through a :class:`repro_torch.serve.PlanService` whose
plans live in that directory, so a restarted server is warm.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

# tuned before the first allocation, as in the reference
from ..sparse.serving import apply_runtime_env, tcmalloc_hint

_APPLIED_ENV = apply_runtime_env()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ..configs import get_config  # noqa: E402
from ..kernels.common import resolve_device  # noqa: E402
from ..models.config import ShapeConfig  # noqa: E402
from ..models import runtime_flags  # noqa: E402
from ..models.model import decode_step, init_model, prefill  # noqa: E402
from ..models.shards import greedy_tokens  # noqa: E402
from .mesh import axis_names, make_host_mesh  # noqa: E402
from .ranks import (  # noqa: E402
    close_ranks,
    init_ranks,
    rank0_print,
    rank_info,
)
from .sharding import (  # noqa: E402
    model_param_bytes,
    node_placer,
    place_on_mesh,
    serving_mode,
)
from .specs import prefill_batch_specs, stub_embeddings  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan-cache-dir", default=None, metavar="DIR",
                    help="persistent plan cache root: plans load on start "
                         "(warm restart) and new plans are written through")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        info = init_ranks(args.device)
        device = info.device
        say = rank0_print(info)
    else:
        device = resolve_device(args.device)
        say = print
    try:
        return _serve(args, device, say)
    finally:
        if rank_info() is not None:
            runtime_flags.set_moe_dispatch(None, None, 0)
            close_ranks()


def _serve(args, device, say):
    ranks = rank_info()
    if _APPLIED_ENV:
        say(f"[serve] tuned runtime env: {_APPLIED_ENV}")
    hint = tcmalloc_hint()
    if hint:
        say(f"[serve] hint: relaunch under '{hint}' for a faster malloc")

    service = None
    if args.plan_cache_dir:
        from ..serve import PlanService

        # every rank runs a service on the one directory (entries are
        # written by atomic replace) and assembles the slot table
        service = PlanService(cache_dir=args.plan_cache_dir, device=device)
        where = ""
        if ranks is not None:
            loaded = [None] * ranks.world
            torch.distributed.all_gather_object(loaded, service.loaded_plans)
            where = f"; plans loaded a rank {loaded}"
        say(f"[serve] plan service: {service.loaded_plans} plans + "
            f"{service.loaded_products} product plans loaded from "
            f"{args.plan_cache_dir}"
            + (" (warm restart)" if service.loaded_plans else " (cold)")
            + where)
        # the continuous-batching slot table (slot s <- request r) as a
        # sparse structure, assembled through the service: the first
        # launch plans and persists it, every later one replays it
        slots = np.arange(1, args.batch + 1)
        service.assemble(slots, slots, np.ones(args.batch),
                         (args.batch, args.batch))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    place = None
    if ranks is not None:
        mesh = make_host_mesh()
        mode = serving_mode(mesh, model_param_bytes(cfg))
        place = node_placer(mesh, mode)
        groups = runtime_flags.set_moe_dispatch(cfg, mesh, args.batch)
        say(f"[serve] ranks={ranks.world} backend={ranks.backend} "
            f"device={device} mesh={dict(zip(axis_names(mesh), mesh.shape))}"
            f" weights={mode} moe_groups={groups}")

    # the rank path runs under no_grad: on torch 2.11 a redistribution
    # inside a local_map region under inference_mode calls aten.detach_,
    # which DTensor has no sharding rule for (PERF.md)
    with torch.inference_mode() if place is None else torch.no_grad():
        if place is None:
            params = init_model(cfg, seed=args.seed, device=device)
        else:
            params = init_model(cfg, seed=args.seed, device=device,
                                place=place)

        # the stub frontends' embeddings (encdec: [B, prompt, D]; vlm:
        # [B, n_vision_tokens, D]), drawn after each batch's tokens
        specs = prefill_batch_specs(cfg, ShapeConfig(
            "serve", args.prompt_len, args.batch, "prefill"))

        def make_batch():
            toks = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
            batch = {"tokens": torch.from_numpy(toks.astype(np.int32))
                     .to(device), **stub_embeddings(specs, rng, device)}
            if place is None:
                return batch
            # every rank drew the same batch and keeps its rows
            return place_on_mesh(mesh, batch, batch=args.batch)

        served = 0
        t0 = time.time()
        while served < args.requests:
            batch = make_batch()
            logits, cache = prefill(params, batch, cfg,
                                    kv_chunk=min(1024, args.prompt_len))
            tok = greedy_tokens(logits, cfg.vocab)
            out_tokens = [tok]
            for _ in range(args.gen - 1):
                logits, cache = decode_step(params, cache,
                                            tok.to(torch.int32), cfg)
                tok = greedy_tokens(logits, cfg.vocab)
                out_tokens.append(tok)
            gen = torch.cat(out_tokens, dim=1)
            if place is not None:
                gen = gen.full_tensor()
            served += args.batch
            say(f"[serve] {served}/{args.requests} done; "
                f"sample row0: {gen[0].cpu().numpy()[:8].tolist()}")
        dt = time.time() - t0
        total_tokens = args.requests * args.gen
        say(f"[serve] {total_tokens} tokens in {dt:.2f}s "
            f"({total_tokens / dt:.1f} tok/s incl. prefill)")
    if service is not None:
        say(f"[serve] plan service stats: {service.stats()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
