"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; mamba:attn 7:1
interleave (attention at index 3 of each 8-layer period), MoE 16e top-2
on every other layer, ssm_state=16 (Jamba uses Mamba-1 state size; the
mixer here is the SSD formulation — DESIGN.md hardware adaptation).

A copy of ``repro/configs/jamba_1_5_large_398b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    d_ff_expert=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_head_dim=128,
    d_inner_mult=2,
    attn_period=8,
    attn_offset=3,
    tie_embeddings=False,
)
