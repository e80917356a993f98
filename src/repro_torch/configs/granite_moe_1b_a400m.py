"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L d_model=1024 16H (GQA kv=8) vocab=49155, MoE 32 experts top-8,
expert d_ff=512, every layer.

A copy of ``repro/configs/granite_moe_1b_a400m.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    d_ff_expert=512,
    vocab=49155,
    n_experts=32,
    top_k=8,
    moe_every=1,
    tie_embeddings=True,
)
