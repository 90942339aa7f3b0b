"""gemma3-1b [dense] — hf:google/gemma-3-1b-pt.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144;
5:1 local:global attention (window 512 local; every 6th layer global),
128k context envelope -> included in the long-context set (local layers
bounded by the window; only the 4 global layers hold full KV).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    qk_norm=True,
    rope_theta=1_000_000.0,
    sliding_window=512,
    local_global_every=6,
    supports_long_context=True,
)
