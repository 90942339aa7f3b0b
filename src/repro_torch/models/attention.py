"""GQA attention: RoPE, qk-norm, sliding windows, cross-attention, caches.

Counterpart of ``repro/models/attention.py``.  Prefill runs the
reference's chunked online softmax over KV blocks of ``kv_chunk``
positions (activation memory O(S * chunk)); decode attends one query
position against the whole KV cache.  The reference computes neither
with a Pallas kernel, so here they are plain ``torch.matmul``/``einsum``
with the reference's numerics: operands in the model dtype, products
accumulated in float32 (the operands are upcast, exactly, before the
float32 matmul), the softmax weights rounded to the value dtype before
the second product.  ``scaled_dot_product_attention`` would mask and
round otherwise, so it is not used.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Params, _dense_init, apply_rope, init_rmsnorm, rmsnorm
from .shards import mesh_of, moved, on_shards, replicate, shard_start, \
    split_last, split_work

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg, *, cross: bool = False):
    D = cfg.d_model
    Dh = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    p = Params({
        "q_in": _dense_init(gen, D, H * Dh, cfg.dtype),
        "k_in": _dense_init(gen, D, Hkv * Dh, cfg.dtype),
        "v_in": _dense_init(gen, D, Hkv * Dh, cfg.dtype),
        "o_out": _dense_init(gen, H * Dh, D, cfg.dtype),
    })
    if cfg.qk_norm and not cross:
        p["q_norm"] = init_rmsnorm(Dh, cfg.dtype, gen.device)
        p["k_norm"] = init_rmsnorm(Dh, cfg.dtype, gen.device)
    return p


def _project_q(params, x, cfg):
    Dh = cfg.resolved_head_dim
    q = split_last(torch.matmul(x, params["q_in"]), cfg.n_heads, Dh)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
    return q


def _project_kv(params, x, cfg):
    Dh = cfg.resolved_head_dim
    k = split_last(torch.matmul(x, params["k_in"]), cfg.n_kv_heads, Dh)
    v = split_last(torch.matmul(x, params["v_in"]), cfg.n_kv_heads, Dh)
    if "k_norm" in params:
        k = rmsnorm(params["k_norm"], k)
    return k, v


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------
def mask_block(q_pos, k_pos, *, causal: bool, window: int):
    """[Sq, Sk] additive mask block from position vectors."""
    d = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok = ok & (d >= 0)
    if window > 0:
        ok = ok & (d < window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention
# ---------------------------------------------------------------------------
def _scaled(q, scale: float):
    """``q * scale`` with the scale rounded to q's dtype first (rounded on
    the host: a scalar copied to the card would wait for its queue)."""
    return q * float(torch.tensor(scale, dtype=q.dtype))


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      kv_chunk: int = 1024, q_offset: int = 0):
    """softmax(q kᵀ / sqrt(Dh) + mask) v with O(S·chunk) memory.

    q: [B, Sq, H, Dh]; k, v: [B, Sk, Hkv, Dh]; GQA via head grouping.
    """
    B, Sq, H, Dh = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    dev = q.device
    qf = _scaled(q, Dh ** -0.5).reshape(B, Sq, Hkv, G, Dh).to(torch.float32)
    C = min(kv_chunk, Sk)
    n_chunks = -(-Sk // C)
    Skp = n_chunks * C
    kp = F.pad(k, (0, 0, 0, 0, 0, Skp - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, Skp - Sk))
    q_pos = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, Dh), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        kb = kp[:, c * C:(c + 1) * C]
        vb = vp[:, c * C:(c + 1) * C]
        k_pos = c * C + torch.arange(C, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf,
                         kb.to(torch.float32))             # [B,Sq,Hkv,G,C]
        msk = mask_block(q_pos, k_pos, causal=causal, window=window)
        msk = torch.where(k_pos[None, :] < Sk, msk, NEG_INF)  # kv padding
        s = s + msk[None, :, None, None, :]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(vb.dtype).to(torch.float32),
            vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _no_reduce(x, op):
    return x


def decode_attention(q, k_cache, v_cache, *, valid=None,
                     reduce=_no_reduce):
    """One-token decode: q [B, 1, H, Dh] over full cache [B, S, Hkv, Dh].

    The whole cache counts as valid (the reference's shape contract)
    unless ``valid`` (``[S]`` bool) masks slots out; q and the softmax
    weights are cast to the cache dtype.  ``reduce(x, op)`` (``op``
    ``"max"`` or ``"sum"``) combines the softmax's max and sum and the
    PV product with the ranks that hold the rest of a cache whose
    sequence is sharded (:func:`_decode_over_cache`); by default none.
    """
    B, _, H, Dh = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = H // Hkv
    qf = _scaled(q, Dh ** -0.5).reshape(B, Hkv, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs",
                     qf.to(k_cache.dtype).to(torch.float32),
                     k_cache.to(torch.float32))
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = reduce(torch.amax(s, dim=-1, keepdim=True), "max")
    p = torch.exp(s - m)
    denom = reduce(torch.sum(p, dim=-1, keepdim=True), "sum")
    out = reduce(torch.einsum("bkgs,bskd->bkgd",
                              (p / denom).to(v_cache.dtype).to(torch.float32),
                              v_cache.to(torch.float32)), "sum")
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def _write_slot_(cache, slot, new):
    """``cache[:, slot] = new`` in place (``cache`` ``[B, S, ...]``,
    ``slot`` ``[1]``).  For a DTensor cache whose sequence is sharded,
    each rank writes its own shard: the new row where the slot falls in
    its range, the row it holds back where not."""
    mesh = mesh_of(cache)
    if mesh is None:
        cache.index_copy_(1, slot, new)
        return
    pl = tuple(cache.placements)
    start = shard_start(cache.shape, mesh, pl, 1)

    def local(c, s, n):
        rel = s - start
        at = rel.clamp(0, c.shape[1] - 1)
        inside = ((rel >= 0) & (rel < c.shape[1])).reshape(
            1, 1, *(1,) * (c.ndim - 2))
        c.index_copy_(1, at, torch.where(inside, n, c.index_select(1, at)))
        return c

    on_shards(local, mesh, (pl, replicate(mesh), moved(pl, {0: 0, 2: 2})),
              pl)(cache, slot, new)


def _write_prefix_(cache, new):
    """``cache[:, :S] = new`` in place (``cache`` ``[B, S_cache, ...]``,
    ``new`` ``[B, S, ...]``).  For a DTensor cache whose sequence is
    sharded, each rank writes the part of the prefix that falls in its
    own range of slots."""
    S = new.shape[1]
    mesh = mesh_of(cache)
    if mesh is None or not _seq_dims(cache):
        cache[:, :S] = new
        return
    pl = tuple(cache.placements)
    start = shard_start(cache.shape, mesh, pl, 1)

    def local(c, n):
        hi = min(start + c.shape[1], S)
        if hi > start:
            c[:, :hi - start] = n[:, start:hi]
        return c

    on_shards(local, mesh, (pl, moved(pl, {0: 0, 2: 2})), pl)(cache, new)


def _decode_window(q, k_cache, v_cache, *, window: int):
    """:func:`decode_attention` over the cache's last ``window`` slots
    (all of them for 0), as the reference takes them."""
    if window > 0:
        S = k_cache.shape[1]
        k_cache, v_cache = k_cache[:, S - window:], v_cache[:, S - window:]
    return decode_attention(q, k_cache, v_cache)


def _seq_dims(cache) -> list:
    """The mesh dims that shard a DTensor cache ``[B, S, Hkv, Dh]``'s
    sequence."""
    from torch.distributed.tensor import Shard

    return [m for m, p in enumerate(cache.placements)
            if isinstance(p, Shard) and p.dim == 1]


def _decode_over_cache(q, k_cache, v_cache, *, window: int = 0):
    """:func:`_decode_window` of ``q`` over the cache.  A DTensor cache
    is read where it lies, the query laid out as the cache's rows and
    heads: each rank runs :func:`decode_attention` on its own slots (the
    window a mask there), and where the sequence is sharded (the
    reference's ``cache_specs`` shard it where the batch or the KV heads
    do not split) its ``reduce`` all-reduces the softmax's max and sum
    and the PV product over the mesh dims that shard it (small
    all-reduces of ``[B, H, ...]``), as GSPMD inserts them for the
    reference (its §Perf iteration 8).  The cache is never gathered."""
    mesh = mesh_of(k_cache)
    if mesh is None:
        return _decode_window(q, k_cache, v_cache, window=window)
    seq = _seq_dims(k_cache)
    pl = tuple(k_cache.placements)
    S = k_cache.shape[1]
    first = S - window if window > 0 else 0
    start = shard_start(k_cache.shape, mesh, pl, 1)
    groups = [(mesh, m) for m in seq]
    q_pl = moved(pl, {0: 0, 2: 2})

    def local(qa, ka, va):
        from torch.distributed import _functional_collectives as funcol

        def over_seq(x, op):
            for g in groups:
                x = funcol.all_reduce(x, op, g)
            return x

        slots = start + torch.arange(ka.shape[1], device=ka.device)
        return decode_attention(qa, ka, va, reduce=over_seq,
                                valid=slots >= first if first else None)

    return on_shards(local, mesh, (q_pl, pl, pl), q_pl)(q, k_cache, v_cache)


def _on_local_heads(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)``; for DTensors, on each rank's own batch rows
    and heads (:func:`~.shards.split_work`; heads split only where the KV
    heads split with them)."""
    mesh = mesh_of(q, k)
    if mesh is None:
        return fn(q, k, v, **kw)
    pl = split_work(q, (0, 2), {2: k.shape[2]})
    return on_shards(lambda a, b, c: fn(a, b, c, **kw), mesh, (pl, pl, pl),
                     pl)(q, k, v)


# ---------------------------------------------------------------------------
# Block-level entry points
# ---------------------------------------------------------------------------
def _out_proj(params, o, B, S):
    return torch.matmul(o.reshape(B, S, -1), params["o_out"])


def self_attention(params, x, cfg, *, positions, causal=True, window=0,
                   kv_chunk=1024):
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = _on_local_heads(chunked_attention, q, k, v, causal=causal,
                        window=window, kv_chunk=kv_chunk)
    return _out_proj(params, o, *x.shape[:2])


def cross_attention(params, x, kv_src, cfg, *, kv_chunk=1024):
    """x attends to encoder/vision states (no mask, no RoPE on kv)."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, kv_src, cfg)
    o = _on_local_heads(chunked_attention, q, k, v, causal=False, window=0,
                        kv_chunk=kv_chunk)
    return _out_proj(params, o, *x.shape[:2])


def _attend_decode_into(params, x, cache_k, cache_v, cfg, *, position,
                        window: int = 0):
    """:func:`self_attention_decode` writing the new K/V into ``cache_k``
    and ``cache_v`` in place; returns the output only."""
    q = _project_q(params, x, cfg)
    k_new, v_new = _project_kv(params, x, cfg)
    pos = torch.as_tensor(position, dtype=torch.int32,
                          device=x.device).expand(x.shape[0], 1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)
    S = cache_k.shape[1]
    slot = (pos[:1, 0] % S).long()
    _write_slot_(cache_k, slot, k_new.to(cache_k.dtype))
    _write_slot_(cache_v, slot, v_new.to(cache_v.dtype))
    if window > S:
        raise ValueError(f"a window of {window} positions needs a cache "
                         f"of at least as many, got {S}")
    o = _decode_over_cache(q, cache_k, cache_v, window=window)
    return _out_proj(params, o, x.shape[0], 1)


def self_attention_decode(params, x, cache_k, cache_v, cfg, *, position,
                          window: int = 0):
    """x: [B, 1, D]; cache_*: [B, S, Hkv, Dh] ring buffers.

    The current token's K/V is ring-written at ``position % S`` first and
    attention runs over the (unchanged-shape) cache; with a window, over
    the cache's last ``window`` slots, as the reference takes them.

    Returns (out [B,1,D], new_cache_k, new_cache_v); the caches passed in
    are left as they were.
    """
    k_all, v_all = cache_k.clone(), cache_v.clone()
    out = _attend_decode_into(params, x, k_all, v_all, cfg,
                             position=position, window=window)
    return out, k_all, v_all


def apply_rope_kv_for_cache(params, x_normed, cfg, positions):
    """K/V projections of a full sequence, RoPE'd for cache storage."""
    k, v = _project_kv(params, x_normed, cfg)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def cross_attention_decode(params, x, cache_k, cache_v, cfg):
    """Decode-side cross-attention over a precomputed source KV cache."""
    q = _project_q(params, x, cfg)
    o = _decode_over_cache(q, cache_k, cache_v)
    return _out_proj(params, o, x.shape[0], 1)
