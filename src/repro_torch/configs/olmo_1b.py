"""olmo-1b [dense] — arXiv:2402.00838.

16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=8192 vocab=50304;
non-parametric LayerNorm (no scale/bias) per the OLMo paper.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    nonparametric_norm=True,
    supports_long_context=False,
)
