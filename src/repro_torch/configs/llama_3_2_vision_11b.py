"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; cross-attention
image layers every 5th layer.  Vision frontend is a STUB per assignment:
``input_specs`` provides precomputed patch embeddings (1601 tokens).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_vision_tokens=1601,
    supports_long_context=False,
)
