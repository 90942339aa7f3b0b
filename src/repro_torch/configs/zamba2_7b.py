"""zamba2-7b [hybrid] — arXiv:2411.15242.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Mamba2 backbone with a *shared* attention(+MLP) block invoked every 6
Mamba blocks (weight re-use across invocations, the Zamba design).
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    # chunk=128: the SSD dual form's intra-chunk buffers scale with Q^2;
    # 128 halves the train-step activation footprint (EXPERIMENTS §Perf iter 9b)
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=128),
    hybrid_attn_every=6,
    supports_long_context=True,   # SSM backbone; 13 attn caches only
)
