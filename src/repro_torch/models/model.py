"""Model assembly: init / forward / prefill / decode (counterpart of
``repro/models/model.py``), for every family: ``dense``, ``moe``,
``ssm`` (Mamba2), ``hybrid`` (Zamba2), ``encdec`` (Seamless-M4T) and
``vlm`` (Llama-3.2-Vision).

A model is one :class:`~repro_torch.models.layers.Params` module: its
``embed`` and ``final_norm`` nodes and an ``nn.ModuleList`` of blocks
under ``layers``, each with the reference's pytree keys (``norm1``,
``attn.q_in``, ``moe.router``, ``moe.gate_ein``, ...).  The reference
stacks its blocks on a leading axis and runs them with ``lax.scan``;
here a Python loop runs the list, and the local:global interleaving,
the hybrid's shared attention block (after every
``hybrid_attn_every``-th Mamba block) and the vlm's cross-attention
(after every ``cross_attn_every``-th layer) are a Python bool per layer
where the reference uses ``lax.cond``.  The hybrid's shared block is one
unstacked set of weights (``shared_norm1``, ``shared_attn``,
``shared_norm2``, ``shared_mlp``) applied at each firing layer.  The
other stacked subtrees are lists too: the encoder's ``enc_layers`` and
the decoder's ``dec_cross`` blocks (``encdec``), and the vlm's
``cross`` blocks, one per firing layer.  The audio and vision
frontends are stubs, as in the reference: a batch carries precomputed
``src_embeds`` or ``vision_embeds``.
:func:`params_from_numpy` and :func:`params_to_numpy` carry weights
across from and back to the reference's stacked pytree.

While autograd records, each unit of the layer loop runs under
activation checkpointing (``runtime_flags.REMAT``, the reference's
``jax.checkpoint`` of its scan body): a block, a Mamba block with the
shared block after it, an encoder block, a decoder block with its
cross-attention, a vlm block with its cross-attention where it fires.
Under ``torch.inference_mode()`` or ``torch.no_grad()`` they run as
they are.  :func:`loss_fn` is the next-token cross-entropy plus the MoE
aux loss.

:func:`decode_step` applies a layer's cross-attention after its MLP, as
:func:`forward` and :func:`prefill` do; the reference's decode applies it
before the MLP and so departs from its own forward (ROADMAP queue C,
C5).

The entry points also run on DTensors placed on a ``DeviceMesh`` (the dry
run, ``launch/dryrun.py``; a mesh of ranks, ``launch/serve.py`` and
``launch/train.py``): plain tensors the model makes (positions, masks)
join them as replicated, :func:`prefill` and :func:`decode_step` place
their logits and caches as the reference's serving steps do, a cache
sharded over its sequence is written and read where it lies
(``attention.py``), and the functions DTensor cannot propagate run on
each rank's shards (``models/shards.py``).
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
    _write_prefix_,
    apply_rope_kv_for_cache,
    cross_attention,
    cross_attention_decode,
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
from .shards import gold_logits, mesh_of, replicating
from .ssm import init_mamba, mamba_decode, mamba_forward
from . import runtime_flags

KV_DTYPE = torch.bfloat16

#: the families this port serves: all of the reference's
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


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


def _keep(name, node, blocks=None):
    return node


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               place=None) -> Params:
    """Random parameters from ``seed`` on ``device`` (the card unless
    asked), drawn by a ``torch.Generator`` on that device.

    With ``place`` (``place(name, node, blocks)``, such as
    ``launch.sharding.node_placer``), each top-level node and each block
    of a stack (``blocks`` long) is handed to it as soon as it is drawn,
    and what it returns is kept: on a rank mesh a rank then holds its
    shards and one whole block at a time.  The draws are the same."""
    device = resolve_device(device)
    keep = place or _keep
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def stack(name, init, n):
        return nn.ModuleList([keep(name, init(gen, cfg), n)
                              for _ in range(n)])

    params = Params()
    params["embed"] = keep("embed", init_embedding(
        gen, cfg.padded_vocab, cfg.d_model, cfg.dtype))
    params["final_norm"] = keep("final_norm", _init_norm(cfg, gen))
    params["layers"] = stack("layers", init_block, cfg.n_layers)
    if _shared_every(cfg):
        params["shared_norm1"] = keep("shared_norm1", _init_norm(cfg, gen))
        params["shared_attn"] = keep("shared_attn",
                                     init_attention(gen, cfg))
        params["shared_norm2"] = keep("shared_norm2", _init_norm(cfg, gen))
        params["shared_mlp"] = keep("shared_mlp", init_mlp(
            gen, cfg.d_model, cfg.d_ff, cfg.dtype))
    if _cross_every(cfg):
        params["cross"] = stack("cross", init_cross_block, _n_cross(cfg))
    if cfg.family == "encdec":
        params["enc_layers"] = stack("enc_layers", init_enc_block,
                                     cfg.n_enc_layers)
        params["enc_final_norm"] = keep("enc_final_norm",
                                        _init_norm(cfg, gen))
        params["dec_cross"] = stack("dec_cross", init_cross_block,
                                    cfg.n_layers)
    return params


def _shared_every(cfg) -> int:
    """The hybrid's shared-block period (0: no shared block)."""
    return cfg.hybrid_attn_every if cfg.family == "hybrid" else 0


def _fires(cfg, idx: int) -> bool:
    """Does the shared attention block follow Mamba layer ``idx``?"""
    every = _shared_every(cfg)
    return bool(every) and (idx + 1) % every == 0


def _cross_every(cfg) -> int:
    """The vlm's cross-attention period (0: no cross blocks)."""
    return cfg.cross_attn_every if cfg.family == "vlm" else 0


def _n_cross(cfg) -> int:
    every = _cross_every(cfg)
    return cfg.n_layers // every if every else 0


def _cross_index(cfg, idx: int):
    """The index of the cross block that follows layer ``idx`` (into its
    stack and into ``ck``/``cv``), or None: every decoder layer's own in
    ``encdec``, one after every ``cross_attn_every``-th layer in
    ``vlm``."""
    if cfg.family == "encdec":
        return idx
    every = _cross_every(cfg)
    if every and (idx + 1) % every == 0:
        return (idx + 1) // every - 1
    return None


def _cross_stack(cfg) -> str:
    """The key of the stacked cross blocks."""
    return "dec_cross" if cfg.family == "encdec" else "cross"


# ---------------------------------------------------------------------------
# Weights carried across from the reference
# ---------------------------------------------------------------------------
#: pytree keys whose subtree carries a leading block axis
_STACKED = ("layers", "enc_layers", "dec_cross", "cross")


def _stack_len(tree) -> int:
    """The leading axis of a stacked subtree's leaves."""
    for v in tree.values():
        n = _stack_len(v) if isinstance(v, dict) else np.shape(v)[0]
        if n is not None:
            return n
    return None


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
    with the leading block axis of the reference's ``vmap``-ped block
    init under each of ``_STACKED`` (``n_layers`` blocks under
    ``layers`` and ``dec_cross``, ``n_enc_layers`` under
    ``enc_layers``, ``n_layers // cross_attn_every`` under ``cross``:
    each count is read off the arrays); bfloat16 leaves stay bfloat16.
    """
    device = resolve_device(device)
    out = Params()
    for k, v in tree.items():
        if k in _STACKED:
            out[k] = nn.ModuleList(
                [_node(v, device, i) for i in range(_stack_len(v))])
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


def _cross_block(cp, x, src, cfg, *, kv_chunk):
    """``x`` plus cross block ``cp``'s attention over ``src`` (encoder
    output or vision embeddings; no norm on that side)."""
    return x + cross_attention(cp["attn"], _apply_norm(cfg, cp.get("norm"), x),
                               src, cfg, kv_chunk=kv_chunk)


def _enc_layer(lp, h, cfg, *, positions, kv_chunk):
    """One encoder block: non-causal self-attention at the source's own
    positions, then the MLP."""
    h, _ = _dense_block(lp, h, cfg, 0, positions=positions, causal=False,
                        kv_chunk=kv_chunk)
    return h


def _cross_layer(lp, cp, x, src, cfg, idx, *, positions, kv_chunk):
    """One decoder (``encdec``) or vlm block and, where a cross block
    ``cp`` follows it, that block's attention over ``src`` (the encoder
    output, the vision embeddings): one checkpointed unit.  The
    decoder's block gets ``idx`` 0, as the reference passes it."""
    idx = 0 if cfg.family == "encdec" else idx
    x, aux = _dense_block(lp, x, cfg, idx, positions=positions, causal=True,
                          kv_chunk=kv_chunk)
    if cp is not None:
        x = _cross_block(cp, x, src, cfg, kv_chunk=kv_chunk)
    return x, aux


def _cross_source(params, batch, cfg, *, kv_chunk):
    """What the cross blocks attend to: the encoder's output over
    ``src_embeds`` (``encdec``) or ``vision_embeds`` (``vlm``)."""
    if cfg.family == "encdec":
        return _encode(params, batch["src_embeds"], cfg, kv_chunk=kv_chunk)
    return batch["vision_embeds"]


def _encode(params, src, cfg, *, kv_chunk):
    """The encoder over ``src`` ``[B, S_src, D]``, then its final norm."""
    positions = _positions(src[..., 0])
    layer = _ckpt(_enc_layer)
    for lp in params["enc_layers"]:
        src = layer(lp, src, cfg, positions=positions, kv_chunk=kv_chunk)
    return _apply_norm(cfg, params.get("enc_final_norm"), src)


def _cross_params(params, cfg, idx: int):
    ci = _cross_index(cfg, idx)
    return None if ci is None else params[_cross_stack(cfg)][ci]


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
    """batch: {"tokens": [B,S]} (+ ``src_embeds`` [B,S_src,D] for
    ``encdec``, ``vision_embeds`` [B,V,D] for ``vlm``). Returns (logits,
    aux)."""
    with replicating(batch["tokens"]):
        return _forward(params, batch, cfg, kv_chunk=kv_chunk)


def _forward(params, batch, cfg, *, kv_chunk):
    tokens = batch["tokens"]
    positions = _positions(tokens)
    x = embed(params["embed"], tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        layer = _ckpt(_ssm_layer)
        for idx, lp in enumerate(params["layers"]):
            x = layer(lp, x, params, cfg, _fires(cfg, idx),
                      positions=positions, kv_chunk=kv_chunk)
    elif cfg.family in ("encdec", "vlm"):
        src = _cross_source(params, batch, cfg, kv_chunk=kv_chunk)
        layer = _ckpt(_cross_layer)
        for idx, lp in enumerate(params["layers"]):
            x, a = layer(lp, _cross_params(params, cfg, idx), x, src, cfg,
                         idx, positions=positions, kv_chunk=kv_chunk)
            aux_total = aux_total + a
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
    with replicating(batch["tokens"]):
        return _loss(params, batch, cfg, kv_chunk=kv_chunk)


def _loss(params, batch, cfg, *, kv_chunk):
    logits, aux = forward(params, batch, cfg, kv_chunk=kv_chunk)
    labels = batch["labels"].long()
    lf = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab:  # mask padded vocab slots
        pad_mask = torch.arange(cfg.padded_vocab,
                                device=lf.device) >= cfg.vocab
        lf = lf.masked_fill(pad_mask, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    # an ignored label reads slot 0; its term is masked out below
    gold = gold_logits(lf, labels.clamp(min=0))
    mask = (labels >= 0).to(torch.float32)
    ce = torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                      min=1.0)
    return ce + aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, *, batch: int, seq_len: int, device=None):
    """Zero cache: ``pos`` and, for the attention families, per-layer K/V
    ring buffers ``[n_layers, batch, seq_len, Hkv, Dh]``; for ``encdec``
    the cross K/V ``ck``/``cv`` of the same shape (``prefill`` replaces
    them by the source's: ``[n_layers, batch, S_src, Hkv, Dh]``); for
    ``vlm`` the vision K/V of each cross block ``[n_layers //
    cross_attn_every, batch, n_vision_tokens, Hkv, Dh]``; for ``ssm``
    and ``hybrid`` the float32 SSM ``state`` ``[n_layers, batch, H, N,
    P]`` and the ``conv`` window ``[n_layers, batch, W-1, conv_ch]``, and
    for ``hybrid`` one K/V ring buffer per shared-block application
    ``[n_layers // every, batch, seq_len, Hkv, Dh]``.  On ``device="meta"``
    nothing is allocated: the shapes and dtypes only."""
    device = resolve_device(device)
    Dh = cfg.resolved_head_dim
    kvd = kv_cache_dtype(cfg)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}

    def kv(n, length):
        return torch.zeros((n, batch, length, cfg.n_kv_heads, Dh),
                           dtype=kvd, device=device)

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
        cache["k"], cache["v"] = kv(n_attn, seq_len), kv(n_attn, seq_len)
    if cfg.family == "encdec":
        cache["ck"] = kv(cfg.n_layers, seq_len)
        cache["cv"] = kv(cfg.n_layers, seq_len)
    if _n_cross(cfg):
        cache["ck"] = kv(_n_cross(cfg), cfg.n_vision_tokens)
        cache["cv"] = kv(_n_cross(cfg), cfg.n_vision_tokens)
    return cache


def _prefill_cache(cfg: ModelConfig, tokens, seq_len: int) -> dict:
    """The zero cache :func:`prefill` fills: on ``tokens``' device, or,
    for a DTensor batch, DTensors on its mesh placed by the cache rules
    (``launch/sharding.py`` ``cache_specs``), each rank allocating only
    its own shards, where the reference's jitted prefill places its
    cache by ``out_shardings``."""
    B = tokens.shape[0]
    mesh = getattr(tokens, "device_mesh", None)
    if mesh is None:
        return init_cache(cfg, batch=B, seq_len=seq_len, device=tokens.device)
    from torch.distributed.tensor import zeros

    from ..launch.sharding import cache_specs, placements

    tpl = init_cache(cfg, batch=B, seq_len=seq_len, device="meta")
    specs = cache_specs(mesh, tpl, cfg, batch=B)
    return {k: zeros(v.shape, dtype=v.dtype, device_mesh=mesh,
                     placements=placements(mesh, specs[k], v.shape))
            for k, v in tpl.items()}


def _ring_write(cache_layer, new, pos):
    """Write [B,1,...] ``new`` at ring position pos % S."""
    S = cache_layer.shape[1]
    slot = (torch.as_tensor(pos, device=cache_layer.device) % S).reshape(1)
    return cache_layer.index_copy(1, slot.long(),
                                  new.to(cache_layer.dtype))


def _cross_decode(cp, x, ck, cv, cfg):
    """``x`` plus cross block ``cp``'s attention over the cached source
    K/V ``ck``/``cv`` ``[B, S_src, Hkv, Dh]``."""
    return x + cross_attention_decode(
        cp["attn"], _apply_norm(cfg, cp.get("norm"), x), ck, cv, cfg)


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One decode step. tokens: [B, 1] -> (logits [B,1,V], cache').

    The caches passed in are left as they were: the step writes into one
    copy of the ring buffers.  The cross K/V (``ck``/``cv``) are only
    read, and come back as the same tensors.  A layer's cross-attention
    follows its MLP, as in :func:`forward` (the reference's decode puts
    it before the MLP: ROADMAP queue C, C5).
    """
    with replicating(tokens):
        if cfg.family in ("ssm", "hybrid"):
            out = _ssm_decode_step(params, cache, tokens, cfg)
        else:
            out = _decode_step(params, cache, tokens, cfg)
        return _served_layout(*out, cfg)


#: what :func:`_served_layout` redistributed, one ``"name: got !=
#: want"`` a leaf, appended as it goes (clear it before a step to read
#: that step's): where DTensor's own propagation left an output unlike
#: the reference's ``out_shardings``
LAYOUT_FIXES: list[str] = []


def _served_layout(logits, cache, cfg):
    """``(logits, cache)`` of a step on a mesh placed as the reference's
    serving steps place their outputs (``out_shardings``:
    ``launch/sharding.py`` ``logits_spec`` and ``cache_specs``): a leaf
    whose placements differ is redistributed, and recorded in
    :data:`LAYOUT_FIXES`; the others are returned as they are.  Plain
    tensors pass through."""
    mesh = mesh_of(logits)
    if mesh is None:
        return logits, cache
    from ..launch.sharding import cache_specs, logits_spec, placements

    B = logits.shape[0]
    specs = cache_specs(mesh, cache, cfg, batch=B)

    def fit(name, t, spec):
        if mesh_of(t) is None:
            return t
        want = placements(mesh, spec)
        if tuple(t.placements) == want:
            return t
        LAYOUT_FIXES.append(f"{name}: {tuple(t.placements)} != {want}")
        return t.redistribute(placements=want)

    return fit("logits", logits, logits_spec(mesh, batch=B)), {
        k: fit(f"cache/{k}", v, specs[k]) for k, v in cache.items()}


def _decode_step(params, cache, tokens, cfg):
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
        ci = _cross_index(cfg, idx) if "ck" in cache else None
        if ci is not None:
            x = _cross_decode(params[_cross_stack(cfg)][ci], x,
                              cache["ck"][ci], cache["cv"][ci], cfg)
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
    stores its RoPE'd K and its V.  For ``encdec`` each decoder layer's
    cross block stores its K/V projection of the encoder output (the
    source's length, not padded); for ``vlm`` each cross block stores
    its K/V projection of the vision embeddings.  ``extra_cache`` pads
    the ring-buffer capacity so the next ``extra_cache`` decode steps
    append without evicting (decode ring-writes at ``pos % capacity``).
    """
    with replicating(batch["tokens"]):
        return _served_layout(*_prefill(params, batch, cfg,
                                        kv_chunk=kv_chunk,
                                        extra_cache=extra_cache), cfg)


def _prefill(params, batch, cfg, *, kv_chunk, extra_cache):
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(tokens)
    x = embed(params["embed"], tokens)
    kvd = kv_cache_dtype(cfg)
    cache = _prefill_cache(cfg, tokens, S + extra_cache)
    if "ck" in cache:  # each cross block's K/V of its source, once
        src = _cross_source(params, batch, cfg, kv_chunk=kv_chunk)
        kvs = [_project_kv(cp["attn"], src, cfg)
               for cp in params[_cross_stack(cfg)]]
        cache["ck"] = torch.stack([k for k, _ in kvs]).to(kvd)
        cache["cv"] = torch.stack([v for _, v in kvs]).to(kvd)
        del kvs
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
                _write_prefix_(cache["k"][ai], k_c.to(kvd))
                _write_prefix_(cache["v"][ai], v_c.to(kvd))
            continue
        k_c, v_c = apply_rope_kv_for_cache(lp["attn"], hn, cfg, positions)
        _write_prefix_(cache["k"][idx], k_c.to(kvd))
        _write_prefix_(cache["v"][idx], v_c.to(kvd))
        kw = dict(positions=positions, kv_chunk=kv_chunk)
        if "ck" in cache:
            x, _ = _cross_layer(lp, _cross_params(params, cfg, idx), x, src,
                                cfg, idx, **kw)
        else:
            x, _ = _dense_block(lp, x, cfg, idx, causal=True, **kw)
    x = _apply_norm(cfg, params.get("final_norm"), x)
    logits = unembed(params["embed"], x[:, -1:, :])
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=tokens.device)
    return logits, cache
