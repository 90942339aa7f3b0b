"""qwen3-0.6b [dense] — hf:Qwen/Qwen3-0.6B family.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; qk_norm,
head_dim=128 (Qwen3 uses wide heads: 16*128 > d_model).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    supports_long_context=False,
)
