"""pixtral-12b [vlm] — hf:mistralai/Pixtral-12B-2409. Mistral-Nemo-style
text backbone; the Pixtral ViT frontend is a stub (input_specs supplies
patch embeddings prepended to the token sequence).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim 128.

A copy of ``repro/configs/pixtral_12b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1.0e6,
    patch_prefix=256,
    tie_embeddings=False,
)
