"""gemma2-9b [dense] — arXiv:2408.00118.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000; alternating
local(4096)/global attention, attn softcap 50, final softcap 30,
head_dim 256, post-norms, (1+w) RMSNorm, scaled embeddings, tied.

A copy of ``repro/configs/gemma2_9b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    local_window=4096,
    alt_local_global=True,
    embed_scale=True,
    post_norms=True,
    norm_offset=1.0,
    tie_embeddings=True,
)
