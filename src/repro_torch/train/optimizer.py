"""AdamW with a float32 master copy (counterpart of
``repro/train/optimizer.py``).

- float32 master copy + float32 first/second moments, one of each per
  parameter, in the parameters' tree (the reference ZeRO-shards them with
  the parameters; the port keeps the state whole on one device);
- cosine LR schedule with linear warmup, decoupled weight decay,
  global-norm clipping;
- the reference's formulas in the reference's order, elementwise in
  float32, outside any kernel.

The state is updated in place: :func:`adamw_update` writes ``master``,
``mu``, ``nu`` and ``count`` into the tensors it was given (the
reference's jitted step donates its state; a functional copy of a
full-width state would not fit beside it on the card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.layers import stacked_leaves, tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    error_feedback: bool = True


def lr_at(cfg: OptConfig, step):
    """The learning rate at ``step`` (a tensor, or an int on the CPU), in
    float32 as the reference computes it.  The cosine is float64's,
    rounded to float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    angle = torch.full_like(step, math.pi) * t
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1 + torch.cos(angle.to(torch.float64)).to(torch.float32)
    )
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptConfig) -> dict[str, Any]:
    """``master`` (a float32 copy of every parameter), ``mu`` and ``nu``
    (float32 zeros) in the parameters' tree, and ``count`` (0-d int32)
    on their device."""
    del cfg

    def f32(p):
        return p.detach().to(torch.float32, copy=True)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return {
        "master": tree_map(f32, params),
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree):
    """sqrt of the sum of squares, leaf by leaf in the reference's leaf
    order (a stacked leaf's blocks summed first)."""
    total = None
    for _, parts, _ in stacked_leaves(tree):
        sq = None
        for g in parts:
            s = torch.sum(torch.square(g.to(torch.float32)))
            sq = s if sq is None else sq + s
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state, cfg: OptConfig):
    """Returns (new_params_in_grads_dtypes, opt_state, metrics).

    ``opt_state`` is consumed: its ``master``, ``mu``, ``nu`` and
    ``count`` are updated in place and returned in the same dict.
    """
    count = opt_state["count"]
    lr = lr_at(cfg, count)
    count.add_(1)
    cf = count.to(torch.float32)

    gn = global_norm(grads)
    scale = torch.clamp(torch.div(torch.full_like(gn, cfg.clip_norm),
                                  gn + 1e-9), max=1.0)
    b1c = 1 - torch.pow(torch.full_like(cf, cfg.b1), cf)
    b2c = 1 - torch.pow(torch.full_like(cf, cfg.b2), cf)
    new_params = []
    for g, p, m, v in zip(tree_leaves(grads),
                          tree_leaves(opt_state["master"]),
                          tree_leaves(opt_state["mu"]),
                          tree_leaves(opt_state["nu"])):
        g32 = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g32 * (1 - cfg.b2) * g32)
        del g32
        # p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)
        den = torch.sqrt(v / b2c).add_(cfg.eps)
        upd = (m / b1c).div_(den)
        del den
        upd.add_(cfg.weight_decay * p).mul_(lr)
        p.sub_(upd)
        del upd
        new_params.append(p.to(g.dtype, copy=True))
    params = tree_unflatten(grads, new_params)
    return params, opt_state, {"lr": lr, "grad_norm": gn}
