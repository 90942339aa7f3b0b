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
draws them.  The model runs on the card
unless ``--device cpu``, under ``torch.inference_mode()``; its weights
are random, drawn from ``--seed`` on the device.

The process environment is tuned at import, as the reference's launcher
does (``repro_torch.sparse.serving.runtime_env``).  ``--plan-cache-dir``
turns on the persistent plan service: the continuous-batching slot table
is assembled through a :class:`repro_torch.serve.PlanService` whose
plans live in that directory, so a restarted server is warm.
"""
from __future__ import annotations

import argparse
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
from ..models.model import decode_step, init_model, prefill  # noqa: E402
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
    device = resolve_device(args.device)

    if _APPLIED_ENV:
        print(f"[serve] tuned runtime env: {_APPLIED_ENV}")
    hint = tcmalloc_hint()
    if hint:
        print(f"[serve] hint: relaunch under '{hint}' for a faster malloc")

    service = None
    if args.plan_cache_dir:
        from ..serve import PlanService

        service = PlanService(cache_dir=args.plan_cache_dir, device=device)
        print(f"[serve] plan service: {service.loaded_plans} plans + "
              f"{service.loaded_products} product plans loaded from "
              f"{args.plan_cache_dir}"
              + (" (warm restart)" if service.loaded_plans else " (cold)"))
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

    with torch.inference_mode():
        params = init_model(cfg, seed=args.seed, device=device)

        # the stub frontends' embeddings (encdec: [B, prompt, D]; vlm:
        # [B, n_vision_tokens, D]), drawn after each batch's tokens
        specs = prefill_batch_specs(cfg, ShapeConfig(
            "serve", args.prompt_len, args.batch, "prefill"))

        def make_batch():
            toks = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
            return {"tokens": torch.from_numpy(toks.astype(np.int32))
                    .to(device), **stub_embeddings(specs, rng, device)}

        served = 0
        t0 = time.time()
        while served < args.requests:
            batch = make_batch()
            logits, cache = prefill(params, batch, cfg,
                                    kv_chunk=min(1024, args.prompt_len))
            tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
            out_tokens = [tok]
            for _ in range(args.gen - 1):
                logits, cache = decode_step(params, cache,
                                            tok.to(torch.int32), cfg)
                tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
                out_tokens.append(tok)
            gen = torch.cat(out_tokens, dim=1)
            served += args.batch
            print(f"[serve] {served}/{args.requests} done; "
                  f"sample row0: {gen[0].cpu().numpy()[:8].tolist()}")
        dt = time.time() - t0
        total_tokens = args.requests * args.gen
        print(f"[serve] {total_tokens} tokens in {dt:.2f}s "
              f"({total_tokens / dt:.1f} tok/s incl. prefill)")
    if service is not None:
        print(f"[serve] plan service stats: {service.stats()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
