"""Mamba2 (SSD — state-space duality) blocks, chunked (counterpart of
``repro/models/ssm.py``).

Implements the SSD algorithm of Dao & Gu 2024 (arXiv:2405.21060): the
sequence is split into chunks of Q tokens; within a chunk the recurrence
is computed in its *dual* quadratic-attention form (batched matmuls),
and a short loop over chunk states carries the recurrence across
chunks.  Decode is the O(1) recurrent update.

The reference computes the scan in ``jnp`` outside any Pallas kernel, so
here it is plain tensor ops (``einsum``, ``cumsum``, ``exp``) with the
reference's float32 upcasts in the same places.  Its inter-chunk
``lax.scan`` is a Python loop over the ``n`` chunks.

Shapes: H ssm heads of head_dim P; state size N; G B/C groups, each
shared by H // G consecutive heads (the GQA analogue for SSMs).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import Params, _dense_init, rmsnorm, torch_dtype
from .shards import mesh_of, moved, on_shards, split_work


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """The reference's ``jnp.linspace(start, stop, num)`` in float32, bit
    for bit.  ``jnp.linspace`` blends the ends, ``start (1 - s) + stop s``
    with ``s = i / (num - 1)``; XLA compiles that to ``start - i (start
    r) + i (stop r)`` with ``r = 1 / (num - 1)`` rounded, the last
    product and sum fused (one rounding, taken here through float64,
    where the float32 product is exact).  ``torch.linspace`` steps from
    both ends and differs in the last bit."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    r = np.float32(1) / np.float32(num - 1)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    head = start - i * float(np.float32(start) * r)
    tail = i.double() * float(np.float32(stop) * r) + head.double()
    return torch.cat([tail.to(torch.float32),
                      torch.full((1,), stop, dtype=torch.float32,
                                 device=device)])


def init_mamba(gen: torch.Generator, cfg):
    D = cfg.d_model
    s = cfg.ssm
    di = s.d_inner(D)
    H = s.n_heads(D)
    G, N, W = s.n_groups, s.d_state, s.conv_width
    conv_ch = di + 2 * G * N
    dtype = torch_dtype(cfg.dtype)
    dev = gen.device
    in_proj = _dense_init(gen, D, 2 * di + 2 * G * N + H, dtype)
    conv_w = (torch.randn((W, conv_ch), generator=gen, device=dev,
                          dtype=torch.float32) * 0.2).to(dtype)
    out_proj = _dense_init(gen, di, D, dtype)
    return Params({
        "in_proj_in": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "a_log": torch.log(_linspace(1.0, 16.0, H, dev)),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "gnorm": Params({"scale": torch.ones((di,), dtype=dtype,
                                             device=dev)}),
        "out_proj_out": out_proj,
    })


def _split_proj(cfg, proj):
    """z, x, B, C, dt along the last axis (``torch.split`` takes the
    sizes where ``jnp.split`` takes the split indices)."""
    D = cfg.d_model
    s = cfg.ssm
    di, H = s.d_inner(D), s.n_heads(D)
    GN = s.n_groups * s.d_state
    z, xc, B, C, dt = torch.split(proj, [di, di, GN, GN, H], dim=-1)
    return z, xc, B, C, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width W: [B, S, ch] -> same.  The taps add
    in float32 in order, then the bias, then silu."""
    W = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros_like(xBC, dtype=torch.float32)
    for i in range(W):
        out = out + pad[:, i:i + S, :].to(torch.float32) \
            * w[i].to(torch.float32)
    return F.silu(out + b.to(torch.float32)).to(xBC.dtype)


def ssd_chunked(xh, dt, A, Bm, Cm, *, chunk: int):
    """Chunked SSD scan.

    xh: [B, S, H, P] inputs; dt: [B, S, H] (softplus'd); A: [H] (<0);
    Bm, Cm: [B, S, G, N], group g shared by heads g * H/G .. (g+1) * H/G - 1.
    Returns y: [B, S, H, P] and final state [B, H, N, P] (float32).
    """
    Bsz, S, H, P = xh.shape
    G = Bm.shape[2]
    rep = H // G
    Q = min(chunk, S)
    n = -(-S // Q)
    Sp = n * Q
    # zero padding of the last chunk: dt = 0 there, so the padded steps
    # neither decay the state nor add to it
    xh = F.pad(xh, (0, 0, 0, 0, 0, Sp - S))
    dt = F.pad(dt, (0, 0, 0, Sp - S))
    Bm = F.pad(Bm, (0, 0, 0, 0, 0, Sp - S))
    Cm = F.pad(Cm, (0, 0, 0, 0, 0, Sp - S))

    xc = xh.reshape(Bsz, n, Q, H, P).to(torch.float32)
    dtc = dt.reshape(Bsz, n, Q, H).to(torch.float32)
    Bc = Bm.reshape(Bsz, n, Q, G, Bm.shape[-1]).to(torch.float32)
    Cc = Cm.reshape(Bsz, n, Q, G, Cm.shape[-1]).to(torch.float32)

    dA = dtc * A[None, None, None, :]              # [B, n, Q, H] (<= 0)
    cum = torch.cumsum(dA, dim=2)                  # within-chunk inclusive
    total = cum[:, :, -1, :]                       # [B, n, H]

    # ---- intra-chunk (dual quadratic form)
    # L[q, k] = exp(cum_q - cum_k) for k <= q else 0
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,n,Q,Q,H]
    q_idx = torch.arange(Q, device=xh.device)
    causal = (q_idx[:, None] >= q_idx[None, :])[None, None, :, :, None]
    # mask the EXPONENT, not the result: the non-causal branch's exp()
    # overflows and would poison the backward pass (0 * inf = NaN).
    Lmat = torch.exp(diff.masked_fill(~causal, float("-inf")))
    # jnp.repeat: each group's row repeated for its H/G heads in turn
    Bh = torch.repeat_interleave(Bc, rep, dim=3)   # [B,n,Q,H,N]
    Ch = torch.repeat_interleave(Cc, rep, dim=3)
    # scores[b,n,q,k,h] = (C_q · B_k) * L[q,k,h]
    scores = torch.einsum("bnqhN,bnkhN->bnqkh", Ch, Bh) * Lmat
    xdt = xc * dtc[..., None]                       # [B,n,Q,H,P]
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", scores, xdt)

    # ---- chunk states: S_n = sum_k exp(total - cum_k) B_k (x dt)_k
    decay_k = torch.exp(total[:, :, None, :] - cum)  # [B,n,Q,H]
    states = torch.einsum("bnkhN,bnkh,bnkhp->bnhNp", Bh, decay_k, xdt)

    # ---- inter-chunk recurrence (sequential over the n chunks)
    h = torch.zeros((Bsz, H, Bh.shape[-1], P), dtype=torch.float32,
                    device=xh.device)
    decay_n = torch.exp(total)                       # [B, n, H]
    prev = []
    for c in range(n):
        prev.append(h)                               # state *before* chunk c
        h = h * decay_n[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(prev, dim=1)                # [B,n,H,N,P]

    # ---- inter-chunk contribution: C_q · (decay to q) h_prev
    decay_q = torch.exp(cum)                         # [B,n,Q,H]
    y_inter = torch.einsum("bnqhN,bnqh,bnhNp->bnqhp", Ch, decay_q, h_prev)

    y = (y_intra + y_inter).reshape(Bsz, Sp, H, P)[:, :S]
    return y, h


def _ssd(xh, dt, A, Bm, Cm, *, chunk: int):
    """:func:`ssd_chunked`; for DTensors, on each rank's own batch rows
    and heads (:func:`~.shards.split_work`).  Heads split only where the
    B/C groups split with them, or where there is one group (then the
    groups are replicated)."""
    mesh = mesh_of(xh)
    if mesh is None:
        return ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk)
    G = Bm.shape[2]
    x_pl = split_work(xh, (0, 2), {2: xh.shape[2] if G == 1 else G})
    g_pl = x_pl if G > 1 else moved(x_pl, {0: 0})
    return on_shards(
        lambda *a: ssd_chunked(*a, chunk=chunk), mesh,
        (x_pl, moved(x_pl, {0: 0, 2: 2}), moved(x_pl, {2: 0}), g_pl, g_pl),
        (x_pl, moved(x_pl, {0: 0, 2: 1})))(xh, dt, A, Bm, Cm)


def _conv(xBC, w, b):
    """:func:`_causal_conv`; for DTensors, on each rank's own batch rows
    and channels (the conv is depthwise)."""
    mesh = mesh_of(xBC)
    if mesh is None:
        return _causal_conv(xBC, w, b)
    pl = split_work(xBC, (0, 2))
    return on_shards(_causal_conv, mesh,
                     (pl, moved(pl, {2: 1}), moved(pl, {2: 0})), pl)(
                         xBC, w, b)


def _on_channels(fn, window, w, b):
    """``fn(window, w, b)`` of the decode conv; for DTensors, on each
    rank's own batch rows and channels: ``[B, ch]`` out."""
    mesh = mesh_of(window)
    if mesh is None:
        return fn(window, w, b)
    pl = split_work(window, (0, 2))
    return on_shards(fn, mesh, (pl, moved(pl, {2: 1}), moved(pl, {2: 0})),
                     moved(pl, {0: 0, 2: 1}))(window, w, b)


def _conv_step(window, w, b):
    """One step of the depthwise conv: ``window [B, W, ch]`` against
    ``w [W, ch]`` plus ``b``, float32, before the silu."""
    return torch.einsum("bwc,wc->bc", window.to(torch.float32),
                        w.to(torch.float32)) + b.to(torch.float32)


def _recurrent_update(dt, A, xh, Bv, Cv, state, d_skip):
    """One step of the SSM recurrence over ``[B, H, ...]`` heads:
    ``(y [B, H, P] float32, new state [B, H, N, P])``."""
    decay = torch.exp(dt * A[None, :])                      # [B,H]
    contrib = torch.einsum("bhN,bhp->bhNp", Bv, xh * dt[..., None])
    h_new = state * decay[..., None, None] + contrib
    y = torch.einsum("bhN,bhNp->bhp", Cv, h_new)
    return y + d_skip[None, :, None] * xh, h_new


def _recurrent(dt, A, xh, Bv, Cv, state, d_skip):
    """:func:`_recurrent_update`; for DTensors, on each rank's own batch
    rows and heads."""
    mesh = mesh_of(state, xh)
    if mesh is None:
        return _recurrent_update(dt, A, xh, Bv, Cv, state, d_skip)
    s_pl = split_work(state, (0, 1))
    bh = moved(s_pl, {0: 0, 1: 1})
    h = moved(s_pl, {1: 0})
    return on_shards(_recurrent_update, mesh, (bh, h, bh, bh, bh, s_pl, h),
                     (bh, s_pl))(dt, A, xh, Bv, Cv, state, d_skip)


def mamba_forward(params, x, cfg, *, return_state: bool = False):
    """Full-sequence Mamba2 block. x: [B, S, D] -> [B, S, D].

    With ``return_state`` also returns ``(ssm_state [B,H,N,P],
    conv_state [B,W-1,conv_ch])`` for prefill -> decode handoff: the
    conv state is the last W-1 rows before the conv, zero-padded in
    front when S < W-1.
    """
    s = cfg.ssm
    D = cfg.d_model
    di, H, P = s.d_inner(D), s.n_heads(D), s.head_dim
    G, N, W = s.n_groups, s.d_state, s.conv_width
    Bsz, S, _ = x.shape

    proj = torch.matmul(x, params["in_proj_in"])
    z, xc, Bm, Cm, dt = _split_proj(cfg, proj)
    xBC_raw = torch.cat([xc, Bm, Cm], dim=-1)
    xBC = _conv(xBC_raw, params["conv_w"], params["conv_b"])
    xc, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)

    # jax.nn.softplus is logaddexp(x, 0); torch's returns x past its
    # threshold of 20, where log1p(exp(-x)) is below half a float32 ulp
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["a_log"])
    xh = xc.reshape(Bsz, S, H, P)
    Bm = Bm.reshape(Bsz, S, G, N)
    Cm = Cm.reshape(Bsz, S, G, N)

    y, h_final = _ssd(xh, dt, A, Bm, Cm, chunk=s.chunk)
    y = y + params["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(Bsz, S, di).to(x.dtype)
    y = rmsnorm(params["gnorm"], y * F.silu(z))
    out = torch.matmul(y, params["out_proj_out"])
    if return_state:
        if S >= W - 1:
            conv_state = xBC_raw[:, S - (W - 1):, :]
        else:  # degenerate tiny-sequence case (smoke tests)
            conv_state = F.pad(xBC_raw, (0, 0, W - 1 - S, 0))
        return out, (h_final, conv_state)
    return out


def mamba_decode(params, x, ssm_state, conv_state, cfg):
    """One-token recurrent update.

    x: [B, 1, D]; ssm_state: [B, H, N, P]; conv_state: [B, W-1, conv_ch].
    Returns (y [B,1,D], new_ssm_state, new_conv_state); the states passed
    in are left as they were.
    """
    s = cfg.ssm
    D = cfg.d_model
    di, H, P = s.d_inner(D), s.n_heads(D), s.head_dim
    G, N = s.n_groups, s.d_state
    Bsz = x.shape[0]

    proj = torch.matmul(x, params["in_proj_in"])
    z, xc, Bm, Cm, dt = _split_proj(cfg, proj)
    xBC_new = torch.cat([xc, Bm, Cm], dim=-1)               # [B, 1, ch]
    # promoted as jnp.concatenate promotes
    window = torch.cat([conv_state, xBC_new], dim=1)        # [B, W, ch]
    conv_out = _on_channels(_conv_step, window, params["conv_w"],
                            params["conv_b"])
    xBC = F.silu(conv_out)[:, None, :].to(x.dtype)
    xc, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])[:, 0]  # [B,H]
    A = -torch.exp(params["a_log"])
    xh = xc.reshape(Bsz, H, P).to(torch.float32)
    Bv = torch.repeat_interleave(Bm.reshape(Bsz, G, N), H // G,
                                 dim=1).to(torch.float32)
    Cv = torch.repeat_interleave(Cm.reshape(Bsz, G, N), H // G,
                                 dim=1).to(torch.float32)

    y, h_new = _recurrent(dt, A, xh, Bv, Cv, ssm_state, params["d_skip"])
    y = y.reshape(Bsz, 1, di).to(x.dtype)
    y = rmsnorm(params["gnorm"], y * F.silu(z))
    out = torch.matmul(y, params["out_proj_out"])
    return out, h_new, window[:, 1:, :].to(conv_state.dtype)

