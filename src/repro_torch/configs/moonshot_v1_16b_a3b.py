"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B.

48L d_model=2048 16H (MHA kv=16) vocab=163840, MoE 64 experts top-6,
expert d_ff=1408, every layer.

A copy of ``repro/configs/moonshot_v1_16b_a3b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    d_ff_expert=1408,
    vocab=163840,
    n_experts=64,
    top_k=6,
    moe_every=1,
    tie_embeddings=False,
)
