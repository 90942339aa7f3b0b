"""Train step: microbatch accumulation, grad compression w/ error
feedback, AdamW (counterpart of ``repro/train/train_step.py``).

Gradient flow:
  1. microbatches run one after another; each microbatch's gradients
     (``torch.autograd.grad``, in the parameters' dtype) are added into
     float32 buffers, as the reference's ``lax.scan`` accumulates them;
  2. the accumulated gradient is *compressed* to bf16 with a float32
     error-feedback buffer carried in the train state (the residual of
     step t is added at step t+1);
  3. AdamW consumes the compressed gradient against the float32 master
     weights.
Steps 2 and 3 are :func:`apply_gradients`, which also takes gradients
handed over from elsewhere (the same gradients on two meshes give the
same update to float32 rounding).

The state is consumed: every step writes the parameters, the optimizer
state, ``ef`` and ``step`` into the tensors it was given (the
reference's launcher donates the state to its jitted step; a second
full-width state would not fit on the card).  Copy a state before a
step to keep it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models.layers import Params, stacked_leaves, tree_leaves, tree_map, \
    tree_unflatten
from ..models.model import (_STACKED, _leaf_to_numpy, _leaf_to_torch,
                            _stack_len, loss_fn, params_from_numpy,
                            params_to_numpy)
from ..models.shards import mesh_of, placed_like, replicating
from .optimizer import OptConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    compress_grads: bool = True     # bf16 + error feedback
    kv_chunk: int = 1024


def init_train_state(params, tcfg: TrainConfig) -> dict[str, Any]:
    """``params``, ``opt`` (:func:`init_opt_state`), ``step`` (0-d int32)
    and, with ``compress_grads``, ``ef`` (float32 zeros), on the
    parameters' device; ``params`` is held, not copied."""
    device = tree_leaves(params)[0].device
    state = {
        "params": params,
        "opt": init_opt_state(params, tcfg.opt),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if tcfg.compress_grads:
        state["ef"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


# ---------------------------------------------------------------------------
# Train states carried across from and back to the reference
# ---------------------------------------------------------------------------
def _tree_from_numpy(tree: dict, device) -> dict:
    out = {}
    for k, v in tree.items():
        if k in _STACKED:
            out[k] = [tree_map(lambda a, i=i: _leaf_to_torch(
                np.asarray(a)[i], device), v) for i in range(_stack_len(v))]
        elif isinstance(v, dict):
            out[k] = _tree_from_numpy(v, device)
        else:
            out[k] = _leaf_to_torch(v, device)
    return out


def train_state_from_numpy(tree: dict, cfg, tcfg: TrainConfig, *,
                           device=None) -> dict[str, Any]:
    """The port's train state from the reference's
    (``jax.tree.map(np.asarray, state)``): ``params`` through
    :func:`~repro_torch.models.model.params_from_numpy`, ``master``,
    ``mu``, ``nu`` and ``ef`` with each stacked block axis split into
    per-block tensors as the parameters are; bfloat16 leaves stay
    bfloat16."""
    device = resolve_device(device)
    opt = tree["opt"]
    state = {
        "params": params_from_numpy(tree["params"], cfg, device=device),
        "opt": {**{k: _tree_from_numpy(opt[k], device)
                   for k in ("master", "mu", "nu")},
                "count": _leaf_to_torch(opt["count"], device)},
        "step": _leaf_to_torch(tree["step"], device),
    }
    if tcfg.compress_grads:
        state["ef"] = _tree_from_numpy(tree["ef"], device)
    return state


def _tree_to_numpy(tree) -> dict:
    if isinstance(tree, Params):
        return params_to_numpy(tree)
    out = {}
    for name, parts, stacked in stacked_leaves(tree):
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = (np.stack([_leaf_to_numpy(t) for t in parts])
                      if stacked else _leaf_to_numpy(parts[0]))
    return out


def train_state_to_numpy(state: dict) -> dict:
    """The reference's train-state pytree (numpy, layers stacked on a
    leading axis) from the port's; bfloat16 leaves come back as float32
    holding the same values (numpy has no bfloat16)."""
    return {k: _tree_to_numpy(v) if isinstance(v, (dict, Params))
            else _leaf_to_numpy(v) for k, v in state.items()}


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------
def _spread_rows(x, n: int):
    """``x`` (a DTensor with rows split on some mesh dims) laid out so
    that each of ``n`` microbatches can spread over its row shards: the
    largest set of those mesh dims whose shards divide ``B / n`` keeps
    them, the others are gathered (each microbatch repeated on them).
    Returns ``(x, shards)``; a plain tensor is ``(x, 1)``.  The choice
    reads only shapes and placements, the same on every rank, so on a
    rank mesh every rank gathers alike."""
    from itertools import combinations

    from torch.distributed.tensor import Replicate

    from ..models.shards import mesh_of

    mesh = mesh_of(x)
    if mesh is None:
        return x, 1
    rows = [m for m, p in enumerate(x.placements)
            if getattr(p, "dim", None) == 0]
    per_mb = x.shape[0] // n
    keep = max((c for k in range(len(rows) + 1)
                for c in combinations(rows, k)
                if per_mb % math.prod(mesh.size(m) for m in c) == 0),
               key=lambda c: math.prod(mesh.size(m) for m in c))
    if len(keep) < len(rows):
        x = x.redistribute(placements=[
            Replicate() if m in rows and m not in keep else p
            for m, p in enumerate(x.placements)])
    return x, math.prod(mesh.size(m) for m in keep)


def _split_microbatches(batch, n: int):
    """[B, ...] -> [n, B//n, ...] for every leaf.  A DTensor whose rows
    are split over ``dp`` shards is split shard by shard: microbatch
    ``i`` takes the ``i``-th ``1/n`` of every shard's rows, so that every
    rank keeps its share of each microbatch (:func:`_spread_rows` first
    gathers the row shards a microbatch is too short to spread over)."""
    def f(x):
        B, rest = x.shape[0], x.shape[1:]
        x, dp = _spread_rows(x, n)
        if dp == 1:
            return x.reshape(n, B // n, *rest)
        return x.reshape(dp, n, B // (dp * n), *rest).transpose(0, 1) \
            .reshape(n, B // n, *rest)
    return {k: f(v) for k, v in batch.items()}


def _add_(xs: list, ys: list) -> None:
    """``xs[i] += ys[i]``: one ``_foreach_add_`` for plain tensors, a
    loop for DTensors (DTensor resolves a ``_foreach`` op's sharding
    afresh at every call, at a cost of many plain ops)."""
    if mesh_of(xs[0]) is None:
        torch._foreach_add_(xs, ys)
    else:
        for x, y in zip(xs, ys):
            x.add_(y)


def _div_(xs: list, d: float) -> None:
    """``xs[i] /= d``, as :func:`_add_`."""
    if mesh_of(xs[0]) is None:
        torch._foreach_div_(xs, d)
    else:
        for x in xs:
            x.div_(d)


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` holds ``tokens`` and ``labels`` ``[B, S]`` on the state's
    device, and the family's stub embeddings where it takes them
    (``src_embeds``, ``vision_embeds``: ``launch/specs.py``); every
    entry is split into microbatches on its leading axis.  The state is consumed: it is updated in place and returned.
    """

    def grads_of(params, leaves, mb):
        with torch.enable_grad():
            loss = loss_fn(params, mb, cfg, kv_chunk=tcfg.kv_chunk)
            return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state, batch):
        with replicating(batch["tokens"]):
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        n = tcfg.microbatches

        if n > 1:
            mbs = _split_microbatches(batch, n)
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            losses = []
            for i in range(n):
                loss, grads = grads_of(params, leaves,
                                       {k: v[i] for k, v in mbs.items()})
                _add_(acc, grads)
                losses.append(loss)
                del grads
            _div_(acc, float(n))
            loss = torch.mean(torch.stack(losses))
        else:
            loss, grads = grads_of(params, leaves, batch)
            acc = [placed_like(g.to(torch.float32), p)
                   for g, p in zip(grads, leaves)]
            del grads

        om = apply_gradients(state, acc, tcfg)
        with torch.no_grad():
            metrics = {"loss": loss, **om, "step": state["step"].clone()}
            state["step"].add_(1)
        return state, metrics

    return train_step


@torch.no_grad()
def apply_gradients(state, grads: list, tcfg: TrainConfig) -> dict:
    """The update half of a train step, in place: ``grads`` (float32, one
    a leaf of ``state["params"]``, placed as that leaf; consumed) is
    compressed to bf16 with error feedback when ``tcfg.compress_grads``,
    then AdamW steps the float32 master and the parameters take its
    result.  Returns AdamW's metrics (``lr``, ``grad_norm``)."""
    params = state["params"]
    leaves = tree_leaves(params)
    # ---- gradient compression with error feedback
    if tcfg.compress_grads:
        ef = tree_leaves(state["ef"])
        _add_(grads, ef)                         # with_ef = g + ef
        used = [a.to(torch.bfloat16) for a in grads]
        for a, s, e in zip(grads, used, ef):     # ef' = with_ef - s
            e.copy_(a.sub_(s))
    else:
        used = list(grads)
    grads.clear()  # consumed: the float32 gradients go before AdamW
    # cast to the param dtypes so adamw mirrors them
    used = [g.to(p.dtype) for p, g in zip(leaves, used)]
    new, opt, om = adamw_update(tree_unflatten(params, used), state["opt"],
                                tcfg.opt)
    del used
    for p, q in zip(leaves, tree_leaves(new)):
        p.copy_(q)
    del new
    state["opt"] = opt
    return om
