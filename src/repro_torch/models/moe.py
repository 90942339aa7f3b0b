"""Mixture-of-Experts with *fsparse-style* counting-sort dispatch.

Counterpart of ``repro/models/moe.py``.  Token routing is the paper's
assembly problem: triplets ``(expert e, token t, gate g)`` with bounded
integer keys, where the combine step sums k contributions per token.
The dispatch is the paper's pipeline, on the port's kernels:

  Part 1  per-block histogram of the expert keys (B12, ``block_histogram``)
          and its exclusive prefix ``jr``: the load and each expert's start
  Part 2  stable counting-sort placement (B11, ``placement``): each
          (token, choice)'s position in expert order, so its slot comes
          straight from its position, with no sort permutation to undo
  capacity crop == nzmax; dropped tokens are the overflow
  Post    combine = *gather* by slot + weighted sum (no colliding scatter)

On the card the two kernels run for every layer call; on the CPU their
plain versions.  With ``G`` token groups (``MOE_GROUPS`` or a mesh's
data shards) the groups are contiguous token ranges, so one counting
sort of the keys ``g * E + e`` over ``G * E`` bins gives every group's
stable order at once: one B12 and one B11 launch per layer call,
whatever G is.  The expert SwiGLU einsums over ``[G, E, C, D]`` are
plain batched matmuls, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.counting_sort.counting_sort import placement
from ..kernels.hist.ops import block_offsets, default_block_b
from ..sparse.ops import scatter_rows
from ..launch.mesh import Mesh, axis_size
from . import runtime_flags
from .layers import Params, torch_dtype
from .shards import mesh_of, on_shards, replicate


def init_moe(gen: torch.Generator, cfg):
    D = cfg.d_model
    E = cfg.moe.n_experts
    F_ = cfg.moe.d_expert
    dtype = torch_dtype(cfg.dtype)
    scale = (1.0 / D) ** 0.5

    def normal(shape, s):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w * s).to(dtype)

    router = torch.randn((D, E), generator=gen, device=gen.device,
                         dtype=torch.float32) * scale
    return Params({
        "router": router,
        "gate_ein": normal((E, D, F_), scale),
        "up_ein": normal((E, D, F_), scale),
        "down_eout": normal((E, F_, D), (1.0 / F_) ** 0.5),
    })


def _group_dispatch(expert_ids, *, n_experts: int, capacity: int,
                    groups: int = 1):
    """Parts 1 and 2 over ``groups`` contiguous groups of keys.

    ``expert_ids`` is ``[G, Lg]`` (token-major choices per group).
    Returns ``slot`` int32 ``[G, Lg]``, each group's own slots in
    ``[0, E*C]`` (E*C: dropped), and ``load`` int32 ``[G, E]``.
    """
    e = expert_ids.reshape(groups, -1).to(torch.int32)
    keys = (e + n_experts * torch.arange(
        groups, dtype=torch.int32, device=e.device)[:, None]).reshape(-1)
    nbins = groups * n_experts
    block_b = default_block_b(nbins, L=keys.shape[0], backend=keys.device)
    offsets, jr = block_offsets(keys, nbins=nbins, block_b=block_b)  # B12
    pos = placement(keys, offsets, nbins=nbins, block_b=block_b,
                    consume_offsets=True)                           # B11
    # rank of each (token, choice) among its group's picks of its expert
    within = pos - jr[:-1][keys.long()]
    slot = torch.where(within < capacity,
                       e.reshape(-1) * capacity + within,
                       n_experts * capacity).to(torch.int32)
    load = (jr[1:] - jr[:-1]).reshape(groups, n_experts)
    return slot.reshape(groups, -1), load


def moe_dispatch_indices(expert_ids, *, n_experts: int, capacity: int):
    """fsparse Parts 1+2 on expert keys: slot per (token, choice).

    expert_ids: int32[L] flattened (token-major) top-k choices.
    Returns ``slot`` int32[L] in [0, E*C] (E*C marks dropped) and the
    per-expert load (the Part-1 histogram), bit for bit the reference's.
    """
    slot, load = _group_dispatch(expert_ids, n_experts=n_experts,
                                 capacity=capacity)
    return slot[0], load[0]


def _capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens, in Python float arithmetic
    as the reference computes it."""
    C = max(8, int(cfg.moe.capacity_factor * cfg.moe.top_k * tokens
                   / cfg.moe.n_experts))
    return -(-C // 8) * 8


def _route(router, xt, cfg, G: int, C: int):
    """Router, top-k and dispatch of ``G`` groups of tokens ``xt [G, TG,
    D]``: ``(xs [G, E, C, D], slot [G, TG*K], gate_vals [G, TG, K],
    load [G, E], probs [G, TG, E])``."""
    G, TG, D = xt.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    dev = xt.device
    logits = torch.matmul(xt.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, experts = torch.topk(probs, K, dim=-1)          # [G, TG, K]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    slot, load = _group_dispatch(experts.reshape(G, TG * K),
                                 n_experts=E, capacity=C, groups=G)
    # token-major triplet order: choice k of token t sits at t*K + k
    token_of = torch.arange(TG * K, device=dev) // K
    dropped = slot >= E * C
    # every group's buffer in one scatter: group g's slots offset by g*E*C
    flat = torch.where(dropped, G * E * C, slot + E * C * torch.arange(
        G, dtype=torch.int32, device=dev)[:, None])
    xs = scatter_rows(flat.reshape(-1), xt[:, token_of].reshape(-1, D),
                      num_slots=G * E * C).reshape(G, E, C, D)
    return xs, slot, gate_vals, load, probs


def _experts(params, xs):
    """The expert FFN (SwiGLU) over ``xs [G, E, C, D]``."""
    g = torch.einsum("gecd,edf->gecf", xs, params["gate_ein"])
    u = torch.einsum("gecd,edf->gecf", xs, params["up_ein"])
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, params["down_eout"])


def _combine(out, slot, gate_vals, C: int):
    """Gather each (t, k)'s slot of ``out [G, E, C, D]`` and sum the
    choices by their gates: ``[G, TG, D]`` float32 (no scatter)."""
    G, E, _, D = out.shape
    TG, K = gate_vals.shape[1:]
    dropped = slot >= E * C
    out_flat = out.reshape(G * E * C, D)
    safe = torch.where(dropped, 0, slot) + E * C * torch.arange(
        G, dtype=torch.int32, device=out.device)[:, None]
    y_tk = out_flat[safe.reshape(-1)].reshape(G, TG, K, D)
    gates = torch.where(dropped.reshape(G, TG, K), 0.0, gate_vals)
    return torch.einsum("gtkd,gtk->gtd", y_tk.to(torch.float32),
                        gates.to(torch.float32))


def _moe_groups(params, x, cfg, G: int, C: int):
    """Router, dispatch, experts and combine over G token groups.

    Returns ``(y [G, TG, D] float32, load [G, E], probs [G, TG, E])``.
    """
    B, S, D = x.shape
    xs, slot, gate_vals, load, probs = _route(
        params["router"], x.reshape(G, B * S // G, D), cfg, G, C)
    y = _combine(_experts(params, xs), slot, gate_vals, C)
    return y, load, probs


def _aux_loss(load, frac_probs, cfg):
    """Switch-style load-balancing loss from the per-group loads."""
    load_total = torch.sum(load, dim=0)
    frac_tokens = load_total.to(torch.float32) / torch.clamp(
        torch.sum(load_total), min=1)
    return (cfg.moe.n_experts * torch.sum(frac_tokens * frac_probs)
            * cfg.moe.aux_loss_weight)


def moe_ffn(params, x, cfg):
    """x: [B, S, D] -> (y, aux_loss).

    With ``runtime_flags.MOE_GROUPS = G`` the dispatch runs per token
    group: each group has its own stable order and capacity.  A mesh set
    by ``runtime_flags.set_moe_mesh`` routes through
    :func:`moe_ffn_shardmap` when its data size divides B.  A DTensor
    ``x`` with no mesh set runs the dispatch whole on every rank
    (:func:`_moe_on_device_mesh` over no batch axes).
    """
    B, S, D = x.shape
    T = B * S
    mm = runtime_flags.moe_mesh()
    if mm is not None:
        mesh, dp_axes = mm
        if B % axis_size(mesh, dp_axes) == 0:
            return moe_ffn_shardmap(params, x, cfg, mesh, dp_axes)
    if mesh_of(x) is not None:
        return _moe_on_device_mesh(params, x, cfg, mesh_of(x), ())
    G = runtime_flags.moe_groups()
    if T % G or B % G:
        G = 1
    y, load, probs = _moe_groups(params, x, cfg, G, _capacity(cfg, T // G))
    aux = _aux_loss(load, torch.mean(probs, dim=(0, 1)), cfg)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_ffn_decode(params, x, cfg):
    """Decode-time MoE: T = B tokens, same path (capacity >= K guaranteed)."""
    y, _ = moe_ffn(params, x, cfg)
    return y


def moe_ffn_shardmap(params, x, cfg, mesh, dp_axes):
    """The reference's ``shard_map`` dispatch.

    On the port's own :class:`~repro_torch.launch.mesh.Mesh` the shards
    share one device, so the per-shard dispatch is the group path with
    one group per data shard (``dp = prod(mesh.shape[a] for a in
    dp_axes)``, capacity from the shard's tokens); the probabilities'
    mean is taken as the reference takes it, the shards' sums over ``dp
    * T_loc``.  On a ``torch.distributed`` ``DeviceMesh`` it is
    :func:`_moe_on_device_mesh`.
    """
    if not isinstance(mesh, Mesh):
        return _moe_on_device_mesh(params, x, cfg, mesh, dp_axes)
    B, S, D = x.shape
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    T_loc = (B // dp) * S
    y, load, probs = _moe_groups(params, x, cfg, dp, _capacity(cfg, T_loc))
    frac_probs = torch.sum(torch.sum(probs, dim=1), dim=0) / (dp * T_loc)
    aux = _aux_loss(load, frac_probs, cfg)
    return y.reshape(B, S, D).to(x.dtype), aux


def _moe_on_device_mesh(params, x, cfg, mesh, dp_axes):
    """The dispatch and the combine on each rank's own tokens
    (``local_map`` over the batch axes ``dp_axes``, as the reference's
    ``shard_map``): B12 and B11 sort the rank's keys, one group per data
    shard.  The expert einsums run on DTensors, the experts on their
    ``model`` shards."""
    from torch.distributed.tensor import Replicate, Shard

    B, S, D = x.shape
    dp = axis_size(mesh, dp_axes)
    C = _capacity(cfg, (B // dp) * S)
    bat = tuple(Shard(0) if a in dp_axes else Replicate()
                for a in mesh.mesh_dim_names)

    def dispatch(router, xb):
        return _route(router, xb.reshape(1, -1, D), cfg, 1, C)

    xs, slot, gate_vals, load, probs = on_shards(
        dispatch, mesh, (replicate(mesh), bat), (bat,) * 5)(
            params["router"], x)

    def combine(out, s, g):
        return _combine(out, s, g, C).reshape(-1, S, D).to(x.dtype)

    # expert parallel: each rank runs its groups' tokens through its own
    # experts (the weights gathered whole over any other axis)
    E = cfg.moe.n_experts
    ep = tuple(Shard(1) if a == "model" and E % mesh.size(m) == 0 else p
               for m, (a, p) in enumerate(zip(mesh.mesh_dim_names, bat)))
    w = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 1
              else Replicate() for p in ep)
    out = on_shards(_experts_local, mesh, (ep, w, w, w), ep)(
        xs, params["gate_ein"], params["up_ein"], params["down_eout"])

    y = on_shards(combine, mesh, (bat, bat, bat), bat)(out, slot, gate_vals)
    return y, _aux_loss(load, torch.mean(probs, dim=(0, 1)), cfg)


def _experts_local(xs, gate_ein, up_ein, down_eout):
    return _experts({"gate_ein": gate_ein, "up_ein": up_ein,
                     "down_eout": down_eout}, xs)
