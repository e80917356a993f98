"""qwen2.5-32b [dense] — hf:Qwen/Qwen2.5 family scaled config.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, QKV bias.

A copy of ``repro/configs/qwen2_5_32b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1.0e6,
    tie_embeddings=False,
)
