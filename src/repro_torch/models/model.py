"""Model assembly: init / forward / prefill / decode (counterpart of
``repro/models/model.py``), for the ``dense``, ``moe``, ``ssm`` (Mamba2)
and ``hybrid`` (Zamba2) families.

A model is one :class:`~repro_torch.models.layers.Params` module: its
``embed`` and ``final_norm`` nodes and an ``nn.ModuleList`` of blocks
under ``layers``, each with the reference's pytree keys (``norm1``,
``attn.q_in``, ``moe.router``, ``moe.gate_ein``, ...).  The reference
stacks its blocks on a leading axis and runs them with ``lax.scan``;
here a Python loop runs the list, and the local:global interleaving and
the hybrid's shared attention block (after every ``hybrid_attn_every``-th
Mamba block) are a Python bool per layer where the reference uses
``lax.cond``.  The hybrid's shared block is one unstacked set of weights
(``shared_norm1``, ``shared_attn``, ``shared_norm2``, ``shared_mlp``)
applied at each firing layer.
:func:`params_from_numpy` and :func:`params_to_numpy` carry weights
across from and back to the reference's stacked pytree.

While autograd records, each block of the layer loop runs under
activation checkpointing (``runtime_flags.REMAT``, the reference's
``jax.checkpoint`` of its scan body); under ``torch.inference_mode()``
or ``torch.no_grad()`` the blocks run as they are.  :func:`loss_fn` is
the next-token cross-entropy plus the MoE aux loss.

The families ``encdec`` and ``vlm`` are not ported yet (ROADMAP queue
A, item 15): their entry points raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..kernels.common import resolve_device
from .attention import (
    _attend_decode_into,
    _project_kv,
    apply_rope_kv_for_cache,
    init_attention,
    self_attention,
)
from .config import ModelConfig
from .layers import (
    Params,
    apply_rope,
    embed,
    init_embedding,
    init_mlp,
    make_norm,
    mlp,
    torch_dtype,
    unembed,
)
from .moe import init_moe, moe_ffn
from .ssm import init_mamba, mamba_decode, mamba_forward
from . import runtime_flags

KV_DTYPE = torch.bfloat16

#: the families this port serves
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet "
            "(ROADMAP queue A, item 15); the port runs "
            f"{', '.join(PORTED_FAMILIES)}")


def kv_cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """Serving-cache (KV / conv) storage dtype: bf16 for half-precision
    models (the cache read is the decode stream), the model's own dtype
    otherwise."""
    dt = torch_dtype(cfg.dtype)
    if dt in (torch.bfloat16, torch.float16):
        return KV_DTYPE
    return dt


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------
def _init_norm(cfg, gen: torch.Generator, d=None):
    init_fn, _ = make_norm(cfg)
    if init_fn is None:
        return Params()
    return init_fn(d or cfg.d_model, cfg.dtype, gen.device)


def _apply_norm(cfg, params, x):
    _, apply_fn = make_norm(cfg)
    return apply_fn(params if params else None, x)


def init_block(gen: torch.Generator, cfg: ModelConfig):
    """One transformer/ssm block's params."""
    _check_family(cfg)
    p = Params()
    p["norm1"] = _init_norm(cfg, gen)
    if cfg.family in ("ssm", "hybrid"):
        p["mamba"] = init_mamba(gen, cfg)
        return p
    p["attn"] = init_attention(gen, cfg)
    p["norm2"] = _init_norm(cfg, gen)
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
    return p


def init_cross_block(gen: torch.Generator, cfg):
    return Params({
        "norm": _init_norm(cfg, gen),
        "attn": init_attention(gen, cfg, cross=True),
    })


def init_enc_block(gen: torch.Generator, cfg):
    return init_block(gen, cfg)  # same structure; masks differ


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random parameters from ``seed`` on ``device`` (the card unless
    asked), drawn by a ``torch.Generator`` on that device."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = Params()
    params["embed"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                     cfg.dtype)
    params["final_norm"] = _init_norm(cfg, gen)
    params["layers"] = nn.ModuleList(
        [init_block(gen, cfg) for _ in range(cfg.n_layers)])
    if _shared_every(cfg):
        params["shared_norm1"] = _init_norm(cfg, gen)
        params["shared_attn"] = init_attention(gen, cfg)
        params["shared_norm2"] = _init_norm(cfg, gen)
        params["shared_mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff,
                                        cfg.dtype)
    return params


def _shared_every(cfg) -> int:
    """The hybrid's shared-block period (0: no shared block)."""
    return cfg.hybrid_attn_every if cfg.family == "hybrid" else 0


def _fires(cfg, idx: int) -> bool:
    """Does the shared attention block follow Mamba layer ``idx``?"""
    every = _shared_every(cfg)
    return bool(every) and (idx + 1) % every == 0


# ---------------------------------------------------------------------------
# Weights carried across from the reference
# ---------------------------------------------------------------------------
#: pytree keys whose subtree carries a leading layer axis
_STACKED = ("layers",)


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _node(tree, device, index=None) -> Params:
    out = Params()
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _node(v, device, index)
        else:
            leaf = v if index is None else np.asarray(v)[index]
            out[k] = _leaf_to_torch(leaf, device)
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig, *, device=None) -> Params:
    """The port's model from the reference's parameter pytree.

    ``tree`` holds numpy arrays (``jax.tree.map(np.asarray, params)``),
    with the leading ``n_layers`` axis of the reference's ``vmap``-ped
    block init under ``layers``; bfloat16 leaves stay bfloat16.
    """
    _check_family(cfg)
    device = resolve_device(device)
    out = Params()
    for k, v in tree.items():
        if k in _STACKED:
            out[k] = nn.ModuleList(
                [_node(v, device, i) for i in range(cfg.n_layers)])
        elif isinstance(v, dict):
            out[k] = _node(v, device)
        else:
            out[k] = _leaf_to_torch(v, device)
    return out


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    # a copy: a train step writes into the tensors in place
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _tree(node) -> dict:
    return {k: (_tree(node[k]) if isinstance(node[k], Params)
                else _leaf_to_numpy(node[k])) for k in node.keys()}


def _stack(trees: list) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else np.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def params_to_numpy(params: Params) -> dict:
    """The reference's pytree (numpy, layers stacked on a leading axis)
    from the port's model; bfloat16 leaves come back as float32 holding
    the same values."""
    out = {}
    for k in params.keys():
        v = params[k]
        if isinstance(v, nn.ModuleList):
            out[k] = _stack([_tree(b) for b in v])
        elif isinstance(v, Params):
            out[k] = _tree(v)
        else:
            out[k] = _leaf_to_numpy(v)
    return out


# ---------------------------------------------------------------------------
# Layer application (full sequence)
# ---------------------------------------------------------------------------
def _layer_window(cfg, idx: int) -> bool:
    """Is layer ``idx`` global (local:global interleaving)?"""
    if cfg.local_global_every:
        return (idx + 1) % cfg.local_global_every == 0
    return cfg.sliding_window == 0


def _dense_block(p, x, cfg, idx, *, positions, causal, kv_chunk):
    if cfg.local_global_every:
        window = 0 if _layer_window(cfg, idx) else cfg.sliding_window
    else:
        window = cfg.sliding_window
    a = self_attention(
        p["attn"], _apply_norm(cfg, p.get("norm1"), x), cfg,
        positions=positions, causal=causal, window=window, kv_chunk=kv_chunk,
    )
    x = x + a
    h = _apply_norm(cfg, p.get("norm2"), x)
    if "moe" in p:
        y, aux = moe_ffn(p["moe"], h, cfg)
    else:
        y = mlp(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def _ssm_block(p, x, cfg):
    return x + mamba_forward(p["mamba"], _apply_norm(cfg, p.get("norm1"), x),
                             cfg)


def _shared_attn_block(params, x, cfg, *, positions, kv_chunk):
    a = self_attention(
        params["shared_attn"], _apply_norm(cfg, params.get("shared_norm1"), x),
        cfg, positions=positions, causal=True, window=0, kv_chunk=kv_chunk,
    )
    x = x + a
    y = mlp(params["shared_mlp"],
            _apply_norm(cfg, params.get("shared_norm2"), x))
    return x + y


def _ssm_layer(lp, x, params, cfg, fire: bool, *, positions, kv_chunk):
    """One Mamba layer and, where it fires, the shared block after it:
    the reference's scan body, one checkpointed unit."""
    x = _ssm_block(lp, x, cfg)
    if fire:
        x = _shared_attn_block(params, x, cfg, positions=positions,
                               kv_chunk=kv_chunk)
    return x


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device).expand(B, S)


# ---------------------------------------------------------------------------
# Activation checkpointing of the layer loop
# ---------------------------------------------------------------------------
def _save_mm(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of unbatched matmuls
    (``aten.mm``: the projections, the router, the unembedding) and
    recompute everything else, the batched einsums (``bmm``) included."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _ckpt(fn):
    """``fn`` under the ``REMAT`` policy while autograd records, else
    ``fn`` itself.  The recompute runs the block's MoE dispatch again
    (B12 and B11 on the card): ``torch.topk`` and the stable counting
    sort are deterministic, so it routes as the forward did."""
    if not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {}
    if runtime_flags.remat() == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_mm)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Forward (scoring): tokens -> logits
# ---------------------------------------------------------------------------
def forward(params, batch, cfg: ModelConfig, *, kv_chunk: int = 1024):
    """batch: {"tokens": [B,S]}. Returns (logits, aux)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    positions = _positions(tokens)
    x = embed(params["embed"], tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        layer = _ckpt(_ssm_layer)
        for idx, lp in enumerate(params["layers"]):
            x = layer(lp, x, params, cfg, _fires(cfg, idx),
                      positions=positions, kv_chunk=kv_chunk)
    else:
        block = _ckpt(_dense_block)
        for idx, lp in enumerate(params["layers"]):
            x, a = block(lp, x, cfg, idx, positions=positions, causal=True,
                         kv_chunk=kv_chunk)
            aux_total = aux_total + a
    x = _apply_norm(cfg, params.get("final_norm"), x)
    return unembed(params["embed"], x), aux_total


def loss_fn(params, batch, cfg: ModelConfig, *, kv_chunk: int = 1024):
    """Next-token cross-entropy (+ MoE aux), in float32 logits; padded
    vocabulary slots are masked, labels below 0 are ignored."""
    logits, aux = forward(params, batch, cfg, kv_chunk=kv_chunk)
    labels = batch["labels"].long()
    lf = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab:  # mask padded vocab slots
        pad_mask = torch.arange(cfg.padded_vocab,
                                device=lf.device) >= cfg.vocab
        lf = lf.masked_fill(pad_mask, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    # an ignored label reads slot 0; its term is masked out below
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    ce = torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                      min=1.0)
    return ce + aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, *, batch: int, seq_len: int, device=None):
    """Zero cache: ``pos`` and, for the attention families, per-layer K/V
    ring buffers ``[n_layers, batch, seq_len, Hkv, Dh]``; for ``ssm`` and
    ``hybrid`` the float32 SSM ``state`` ``[n_layers, batch, H, N, P]``
    and the ``conv`` window ``[n_layers, batch, W-1, conv_ch]``, and for
    ``hybrid`` one K/V ring buffer per shared-block application
    ``[n_layers // every, batch, seq_len, Hkv, Dh]``."""
    _check_family(cfg)
    device = resolve_device(device)
    Dh = cfg.resolved_head_dim
    kvd = kv_cache_dtype(cfg)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        H = s.n_heads(cfg.d_model)
        conv_ch = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
        cache["state"] = torch.zeros(
            (cfg.n_layers, batch, H, s.d_state, s.head_dim),
            dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros(
            (cfg.n_layers, batch, s.conv_width - 1, conv_ch), dtype=kvd,
            device=device)
        every = _shared_every(cfg)
        n_attn = cfg.n_layers // every if every else 0
    else:
        n_attn = cfg.n_layers
    if n_attn:
        shape = (n_attn, batch, seq_len, cfg.n_kv_heads, Dh)
        cache["k"] = torch.zeros(shape, dtype=kvd, device=device)
        cache["v"] = torch.zeros(shape, dtype=kvd, device=device)
    return cache


def _ring_write(cache_layer, new, pos):
    """Write [B,1,...] ``new`` at ring position pos % S."""
    S = cache_layer.shape[1]
    slot = (torch.as_tensor(pos, device=cache_layer.device) % S).reshape(1)
    return cache_layer.index_copy(1, slot.long(),
                                  new.to(cache_layer.dtype))


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One decode step. tokens: [B, 1] -> (logits [B,1,V], cache').

    The caches passed in are left as they were: the step writes into one
    copy of them.
    """
    _check_family(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return _ssm_decode_step(params, cache, tokens, cfg)
    pos = cache["pos"]
    x = embed(params["embed"], tokens)
    k_all, v_all = cache["k"].clone(), cache["v"].clone()
    for idx, lp in enumerate(params["layers"]):
        hn = _apply_norm(cfg, lp.get("norm1"), x)
        window = 0
        if cfg.local_global_every and not _layer_window(cfg, idx):
            window = cfg.sliding_window
        a = _attend_decode_into(lp["attn"], hn, k_all[idx], v_all[idx], cfg,
                                position=pos, window=window)
        x = x + a
        h2 = _apply_norm(cfg, lp.get("norm2"), x)
        if "moe" in lp:
            y, _ = moe_ffn(lp["moe"], h2, cfg)
        else:
            y = mlp(lp["mlp"], h2)
        x = x + y
    x = _apply_norm(cfg, params.get("final_norm"), x)
    logits = unembed(params["embed"], x)
    return logits, dict(cache, k=k_all, v=v_all, pos=pos + 1)


def _ssm_decode_step(params, cache, tokens, cfg):
    """:func:`decode_step` for ``ssm`` and ``hybrid``: each Mamba layer's
    recurrent update, and the shared block of application ``ai`` reading
    and ring-writing its own K/V cache ``ai`` at ``pos``."""
    pos = cache["pos"]
    x = embed(params["embed"], tokens)
    out = dict(cache)
    if "k" in cache:
        out["k"], out["v"] = cache["k"].clone(), cache["v"].clone()
    states, convs = [], []
    for idx, lp in enumerate(params["layers"]):
        hn = _apply_norm(cfg, lp.get("norm1"), x)
        o, st, cv = mamba_decode(lp["mamba"], hn, cache["state"][idx],
                                 cache["conv"][idx], cfg)
        x = x + o
        states.append(st)
        convs.append(cv)
        if _fires(cfg, idx):
            ai = (idx + 1) // _shared_every(cfg) - 1
            hn2 = _apply_norm(cfg, params.get("shared_norm1"), x)
            x = x + _attend_decode_into(params["shared_attn"], hn2,
                                        out["k"][ai], out["v"][ai], cfg,
                                        position=pos)
            x = x + mlp(params["shared_mlp"],
                        _apply_norm(cfg, params.get("shared_norm2"), x))
    out["state"], out["conv"] = torch.stack(states), torch.stack(convs)
    x = _apply_norm(cfg, params.get("final_norm"), x)
    logits = unembed(params["embed"], x)
    out["pos"] = pos + 1
    return logits, out


def prefill(params, batch, cfg: ModelConfig, *, kv_chunk: int = 1024,
            extra_cache: int = 0):
    """Full forward that also *builds* the KV/state caches.

    Returns (last-token logits [B,1,V], cache).  For ``ssm`` and
    ``hybrid`` the chunked scan's final state and the last ``W-1``
    pre-conv rows are the cache, and each shared-block application
    stores its RoPE'd K and its V.  ``extra_cache`` pads
    the ring-buffer capacity so the next ``extra_cache`` decode steps
    append without evicting (decode ring-writes at ``pos % capacity``).
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(tokens)
    x = embed(params["embed"], tokens)
    kvd = kv_cache_dtype(cfg)
    cache = init_cache(cfg, batch=B, seq_len=S + extra_cache,
                       device=tokens.device)
    for idx, lp in enumerate(params["layers"]):
        hn = _apply_norm(cfg, lp.get("norm1"), x)
        if cfg.family in ("ssm", "hybrid"):
            y, (st, cv) = mamba_forward(lp["mamba"], hn, cfg,
                                        return_state=True)
            cache["state"][idx] = st
            cache["conv"][idx] = cv.to(kvd)
            x = x + y
            if _fires(cfg, idx):
                ai = (idx + 1) // _shared_every(cfg) - 1
                hn2 = _apply_norm(cfg, params.get("shared_norm1"), x)
                k_c, v_c = _project_kv(params["shared_attn"], hn2, cfg)
                k_c = apply_rope(k_c, positions, cfg.rope_theta)
                x = _shared_attn_block(params, x, cfg, positions=positions,
                                       kv_chunk=kv_chunk)
                cache["k"][ai, :, :S] = k_c.to(kvd)
                cache["v"][ai, :, :S] = v_c.to(kvd)
            continue
        k_c, v_c = apply_rope_kv_for_cache(lp["attn"], hn, cfg, positions)
        cache["k"][idx, :, :S] = k_c.to(kvd)
        cache["v"][idx, :, :S] = v_c.to(kvd)
        x, _ = _dense_block(lp, x, cfg, idx, positions=positions,
                            causal=True, kv_chunk=kv_chunk)
    x = _apply_norm(cfg, params.get("final_norm"), x)
    logits = unembed(params["embed"], x[:, -1:, :])
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=tokens.device)
    return logits, cache
