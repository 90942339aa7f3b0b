"""Model configuration system.

A copy of ``repro/models/config.py``, which holds no JAX: the port
imports nothing of the reference package.  One frozen dataclass
describes every assigned architecture; family selects the block
structure.  Configs are constructed in ``repro_torch.configs.<arch>``
and may be reduced uniformly for smoke tests via
:meth:`ModelConfig.reduced`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention options
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = always global
    local_global_every: int = 0      # >0: layer l is GLOBAL iff (l+1) % every == 0
    nonparametric_norm: bool = False
    tie_embeddings: bool = True
    # moe
    moe: MoEConfig = MoEConfig()
    # ssm / hybrid
    ssm: SSMConfig = SSMConfig()
    hybrid_attn_every: int = 0       # >0: shared attention after every k-th ssm block
    # encoder-decoder
    n_enc_layers: int = 0            # >0 selects enc-dec split; n_layers = decoder layers
    # vlm
    cross_attn_every: int = 0        # >0: cross-attn layer every k layers
    n_vision_tokens: int = 0         # stub frontend: #patch/frame embeddings
    # numerics
    dtype: str = "bfloat16"
    # serving envelope
    supports_long_context: bool = False   # sub-quadratic path exists

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a 256 multiple (Megatron-style) so the
        embedding shards evenly on a 16-way model axis; padded logits
        are masked in the loss."""
        return -(-self.vocab // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6ND."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        Dh = self.resolved_head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * (self.n_heads * Dh) + 2 * D * (self.n_kv_heads * Dh) \
            + (self.n_heads * Dh) * D
        if self.is_moe:
            ffn = self.moe.n_experts * 3 * D * self.moe.d_expert
        else:
            ffn = 3 * D * F if F else 0
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di = self.ssm.d_inner(D)
            H = self.ssm.n_heads(D)
            G = self.ssm.n_groups
            ssm = (
                D * (2 * di + 2 * G * self.ssm.d_state + H)  # in_proj
                + di * D                                     # out_proj
                + self.ssm.conv_width * (di + 2 * G * self.ssm.d_state)
                + 3 * H
            )
        per_layer = {
            "dense": attn + ffn,
            "moe": attn + ffn,
            "ssm": ssm,
            "hybrid": ssm,
            "encdec": 2 * attn + ffn,   # dec has self+cross attn
            "vlm": attn + ffn,
        }[self.family]
        total = emb + self.n_layers * per_layer
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + ffn)
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += attn + 3 * D * F  # one shared attention (+MLP) block
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * attn  # cross-attention projections
        return total

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts)."""
        if not self.is_moe:
            return self.n_params
        D = self.d_model
        dense_ffn = self.moe.n_experts * 3 * D * self.moe.d_expert
        active_ffn = self.moe.top_k * 3 * D * self.moe.d_expert
        return self.n_params - self.n_layers * (dense_ffn - active_ffn)

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32,
        )
        if self.is_moe:
            small["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2), d_expert=64,
            )
        if self.family in ("ssm", "hybrid"):
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=16
            )
        if self.n_enc_layers:
            small["n_enc_layers"] = 2
        if self.cross_attn_every:
            small["cross_attn_every"] = 2
            small["n_vision_tokens"] = 16
        if self.local_global_every:
            small["local_global_every"] = 2
            small["sliding_window"] = 8
        if self.hybrid_attn_every:
            small["hybrid_attn_every"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: training or serving geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
