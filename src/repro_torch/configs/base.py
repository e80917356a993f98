"""Architecture configuration schema for the LM framework.

The port's copy of ``repro/configs/base.py``, field for field, so that a
config means the same model in both packages and the tests compare like
with like.  One frozen dataclass describes every assigned architecture
family (dense / MoE / SSM / hybrid / enc-dec / VLM); the port runs all
but enc-dec and VLM.  ``reduced()`` derives the CPU-sized smoke-test
variant of any config (same family and wiring, tiny widths).
``dtype`` stays a string (``"bfloat16"``, ``"float32"``);
:func:`torch_dtype` maps it to a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    rms_eps: float = 1.0e-6
    tie_embeddings: bool = True

    # gemma2-isms
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    local_window: int = 0           # >0: window for local layers
    alt_local_global: bool = False  # alternate local/global attention
    embed_scale: bool = False       # multiply embeddings by sqrt(d_model)
    post_norms: bool = False        # extra post-attn/post-ffn RMSNorms
    norm_offset: float = 0.0        # gemma uses (1 + w) RMSNorm weights

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1              # 1 = every layer, 2 = alternating
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    d_inner_mult: int = 2
    attn_period: int = 0            # jamba: one attn layer per this many
    attn_offset: int = 0            # ...at this index within the period

    # enc-dec (whisper backbone; conv frontend stubbed)
    encoder_layers: int = 0
    encoder_seq: int = 0            # precomputed frame embeddings length
    use_layernorm_gelu: bool = False

    # VLM (pixtral backbone; patch frontend stubbed)
    patch_prefix: int = 0           # precomputed patch embeddings length

    dtype: str = "bfloat16"

    # --- beyond-paper performance knobs (EXPERIMENTS.md §Perf) --------
    # Pad query heads to a TP-divisible count (zero-masked: exact math).
    pad_heads_to: int = 0
    # Causal attention in query chunks, keys sliced to the causal prefix
    # (XLA-expressible flash-style flop/memory reduction). 0 = full T^2.
    attn_chunk_q: int = 0
    # Prefill attends over the fresh K/V (pre-cache-write) instead of the
    # padded cache — exact for from-scratch prefill (cache_pos=0), and
    # unlocks the chunked formulation for the prefill path.
    prefill_fresh_kv: bool = False

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))

    @property
    def padded_heads(self) -> int:
        hp = max(self.n_heads, self.pad_heads_to or 0)
        # padding happens within KV groups so the GQA q->kv mapping of
        # the real heads is preserved; a target that breaks group
        # structure is ignored
        if self.n_kv_heads and hp % self.n_kv_heads != 0:
            return self.n_heads
        return hp

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (DESIGN.md §5)"""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return (i % self.attn_period) == self.attn_offset
        return True

    def layer_window(self, i: int) -> int:
        """Sliding window for layer i (gemma2: even layers local)."""
        if self.alt_local_global:
            return self.local_window if i % 2 == 0 else 0
        return self.local_window

    # ------------------------------------------------------------------ #
    def param_count(self) -> Tuple[int, int]:
        """(total, active) parameter estimates — drives MODEL_FLOPS."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = 3 * d * self.d_ff_expert
        total = active = 0
        n_mixer_layers = self.n_layers
        for i in range(self.n_layers):
            if self.family == "ssm" or (self.family == "hybrid"
                                        and not self.is_attn_layer(i)):
                din = self.d_inner
                mixer = d * (2 * din + 2 * self.ssm_state
                             + self.ssm_heads) \
                    + din * self.ssm_conv + din * d + 2 * self.ssm_heads
            else:
                mixer = attn
            if self.is_moe_layer(i):
                ffn_t = self.n_experts * moe_ffn + d * self.n_experts
                ffn_a = self.top_k * moe_ffn + d * self.n_experts
            elif self.family == "encdec" or self.use_layernorm_gelu:
                ffn_t = ffn_a = 2 * d * self.d_ff
            else:
                ffn_t = ffn_a = dense_ffn
            total += mixer + ffn_t
            active += mixer + ffn_a
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total += emb
        active += emb
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + 2 * d * self.d_ff)
            total += enc
            active += enc
        return total, active

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small_heads = min(self.n_heads, 4)
        kv = max(1, small_heads * self.n_kv_heads
                 // self.n_heads) if self.n_heads else 0
        period = self.attn_period or 1
        layers = max(2, min(4, self.n_layers))
        if self.family == "hybrid":
            layers = period  # one full interleave group
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=layers,
            d_model=64,
            n_heads=small_heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            d_ff_expert=32 if self.n_experts else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            patch_prefix=min(self.patch_prefix, 8),
            local_window=min(self.local_window, 16),
            dtype="float32",
        )


def torch_dtype(name: str):
    """The ``torch.dtype`` of a config's ``dtype`` string."""
    import torch
    return getattr(torch, name)
