"""qwen1.5-4b [dense] — hf:Qwen/Qwen1.5 family scaled config.

40L d_model=2560 20H (GQA kv=20 => MHA) d_ff=6912 vocab=151936, QKV bias.

A copy of ``repro/configs/qwen1_5_4b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1.0e4,
    tie_embeddings=False,
)
