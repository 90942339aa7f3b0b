"""olmoe-1b-7b [moe] — arXiv:2409.02060; hf.

16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8; qk-norm per the OLMoE paper.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    qk_norm=True,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024, capacity_factor=1.25),
    supports_long_context=False,
)
