"""whisper-tiny [audio] — arXiv:2212.04356. Enc-dec backbone; the conv
mel frontend is a stub (input_specs supplies frame embeddings).

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865, LayerNorm+GELU.

A copy of ``repro/configs/whisper_tiny.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    encoder_layers=4,
    encoder_seq=1500,
    use_layernorm_gelu=True,
    tie_embeddings=True,
)
