"""seamless-m4t-medium [audio enc-dec] — arXiv:2308.11596; hf.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.  Multimodal
frontend is a STUB per assignment: ``input_specs`` provides precomputed
audio-frame embeddings for the encoder; the decoder is a text LM.
12 encoder + 12 decoder layers (the "12L" backbone on both sides).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder
    n_enc_layers=12,        # encoder
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    rope_theta=10_000.0,
    supports_long_context=False,
)
