"""Primitive layers over parameter trees (counterpart of
``repro/models/layers.py``).

The reference keeps its parameters in a pytree of dicts; the port keeps
them in :class:`Params` modules under the same keys, so that
``params["gate_in"]``, ``"q_norm" in params`` and ``params.get("norm1")``
read as the reference's code does, and a model is one ``nn.Module``.
Random initialisation draws from an explicit ``torch.Generator`` whose
device is where the parameters land.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """One node of the parameter tree: tensors (as ``nn.Parameter``) and
    child nodes under the reference's pytree keys."""

    def __init__(self, entries: dict | None = None):
        super().__init__()
        for k, v in (entries or {}).items():
            self[k] = v

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, nn.Module):
            self.add_module(key, value)
        else:
            self.register_parameter(key, nn.Parameter(
                value, requires_grad=value.is_floating_point()))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def __len__(self) -> int:
        return len(self._parameters) + len(self._modules)

    def keys(self) -> list:
        return list(self._parameters) + list(self._modules)

    def get(self, key: str, default=None):
        return self[key] if key in self else default


# ---------------------------------------------------------------------------
# Trees: Params modules and nested dicts, with a list (``nn.ModuleList``)
# of same-shaped blocks where the reference stacks them on a leading axis
# ---------------------------------------------------------------------------
def _is_node(x) -> bool:
    return isinstance(x, (Params, dict))


def _is_stack(x) -> bool:
    return isinstance(x, (nn.ModuleList, list, tuple))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each of
    ``rest``); nodes come back as dicts, stacks as lists."""
    if _is_node(tree):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree.keys())}
    if _is_stack(tree):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in :func:`tree_map`'s order: sorted keys, as
    ``jax.tree.leaves`` orders a dict, and a stack's blocks one after
    another."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (in
    :func:`tree_leaves`' order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def stacked_leaves(tree, prefix: str = "") -> list:
    """``(name, parts, stacked)`` for each leaf of the reference's pytree,
    in its order: ``name`` joins the keys with ``/``; a stack's blocks
    contribute one leaf per name, ``parts`` holding each block's tensor
    (``stacked`` true: the reference's leaf is them stacked on a leading
    axis); any other leaf is ``([leaf], False)``."""
    if _is_node(tree):
        return [leaf for k in sorted(tree.keys())
                for leaf in stacked_leaves(tree[k], f"{prefix}{k}/")]
    if _is_stack(tree):
        per_block = [stacked_leaves(t, prefix) for t in tree]
        return [(name, [b[i][1][0] for b in per_block], True)
                for i, (name, _, _) in enumerate(per_block[0])]
    return [(prefix[:-1], [tree], False)]


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _dense_init(gen: torch.Generator, d_in, d_out, dtype, scale=None):
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(torch_dtype(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_rmsnorm(d, dtype, device=None):
    return Params({"scale": torch.ones((d,), dtype=torch_dtype(dtype),
                                       device=device)})


def rmsnorm(params, x, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if params is not None:
        y = y * params["scale"].to(torch.float32)
    return y.to(x.dtype)


def nonparametric_layernorm(x, eps=1e-5):
    """OLMo-style non-parametric LN: no scale, no bias."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def make_norm(cfg):
    """Returns (init_fn|None, apply_fn) honoring nonparametric_norm."""
    if cfg.nonparametric_norm:
        return None, lambda p, x: nonparametric_layernorm(x)
    return init_rmsnorm, rmsnorm


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, vocab, d, dtype):
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return Params({"embedding": (w * 0.02).to(torch_dtype(dtype))})


#: route the embedding backward through the fsparse-style counting-sort
#: accumulation (repro_torch.train.sparse_grads)
USE_SPARSE_EMBED_GRAD = True


def embed(params, tokens):
    if USE_SPARSE_EMBED_GRAD:
        from ..train.sparse_grads import sparse_grad_embed
        return sparse_grad_embed(params["embedding"], tokens)
    return params["embedding"][tokens]


def unembed(params, x):
    """Logits against the (possibly tied) embedding table."""
    return torch.matmul(x, params["embedding"].T)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim, theta, device=None):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(theta, exps)  # float32, with no scalar copied over


def apply_rope(x, positions, theta):
    """x: [..., S, H, Dh]; positions: [..., S].  Half-split rotation."""
    Dh = x.shape[-1]
    freqs = rope_frequencies(Dh, theta, device=x.device)      # [Dh/2]
    angles = positions[..., :, None].to(torch.float32) * freqs  # [..., S, Dh/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model, d_ff, dtype):
    return Params({
        "gate_in": _dense_init(gen, d_model, d_ff, dtype),
        "up_in": _dense_init(gen, d_model, d_ff, dtype),
        "down_out": _dense_init(gen, d_ff, d_model, dtype),
    })


def mlp(params, x):
    g = torch.matmul(x, params["gate_in"])
    u = torch.matmul(x, params["up_in"])
    return torch.matmul(F.silu(g) * u, params["down_out"])
