"""starcoder2-15b [dense] — arXiv:2402.19173.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152; GQA + RoPE.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    rope_theta=100_000.0,
    supports_long_context=False,
)
