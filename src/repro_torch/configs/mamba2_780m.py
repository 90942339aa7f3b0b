"""mamba2-780m [ssm] — arXiv:2405.21060 (SSD).

48L d_model=1536 attention-free, vocab=50280, ssm_state=128.
Standard Mamba2 hyper-parameters: expand=2 (d_inner=3072), headdim=64
(H=48 ssm heads), conv width 4, chunk 256.
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,              # no attention heads
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    supports_long_context=True,   # O(1) state decode
)
