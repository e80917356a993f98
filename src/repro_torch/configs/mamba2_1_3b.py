"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

48L d_model=2048, attention-free, vocab=50280, ssm_state=128,
d_inner=2*d_model, head_dim 64.

A copy of ``repro/configs/mamba2_1_3b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_head_dim=64,
    d_inner_mult=2,
    tie_embeddings=True,
)
