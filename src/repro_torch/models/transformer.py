"""Decoder-only LM assembly, dense family.

The counterpart of ``repro/models/transformer.py``: ``period_of``,
``_init_block``/``_block_fwd`` (attention plus MLP), ``init_model``,
``forward`` and ``init_cache``, in the reference's stacked layout.  Layers
are grouped by the repeat period (2 for gemma2's local/global
alternation, else 1); every parameter of period position ``pos`` is
stacked over the ``n_groups = n_layers // period`` groups, and the decode
cache is a tuple over period positions of ``(k, v)``, each
``(n_groups, B, Hkv, S, D)``.  Layer ``g * period + pos`` reads group ``g``
at position ``pos``.

The reference drives the stack with ``jax.lax.scan``; here it is a
Python loop over the layers, reading views of the stacked tensors.  The
cache is written in place (``layers.attention_fwd``) and the same tuple
comes back as the new cache.  The MoE and SSM branches, and the other
families, are not ported yet (ROADMAP Queue 1 item 11): they raise.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.layers import Params

#: parameter names that stay float32 (norm weights)
NORMS = frozenset({"ln1", "ln2", "ln1_post", "ln2_post", "final_norm"})

_NOT_PORTED = ("not ported yet: the port runs the dense family only "
               "(ROADMAP Queue 1 item 11)")


def check_dense(cfg: ModelConfig) -> None:
    """Raise for what the port cannot run yet: MoE and SSM blocks and the
    non-dense families."""
    if cfg.family != "dense" or cfg.n_experts or cfg.ssm_state:
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): "
                                  f"{_NOT_PORTED}")


def period_of(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.attn_period
    p = 1
    if cfg.alt_local_global:
        p = 2
    if cfg.n_experts and cfg.moe_every > 1:
        p = max(p, cfg.moe_every)
    return p


def _init_block(gen: torch.Generator, cfg: ModelConfig, pos: int,
                n_groups: int, device) -> dict:
    """Period position ``pos``, stacked over ``n_groups``: attention, MLP
    and norms."""
    if not cfg.is_attn_layer(pos) or cfg.is_moe_layer(pos):
        raise NotImplementedError(f"{cfg.name}: SSM and MoE blocks are "
                                  f"{_NOT_PORTED}")
    ones = torch.ones((n_groups, cfg.d_model), dtype=torch.float32,
                      device=device)
    p = {"ln1": ones, "ln2": ones.clone()}
    if cfg.post_norms:
        p["ln1_post"] = ones.clone()
        p["ln2_post"] = ones.clone()
    p["attn"] = L.init_attention(gen, cfg, device, lead=(n_groups,))
    p["mlp"] = L.init_mlp(gen, cfg, device, lead=(n_groups,))
    return p


def _block_fwd(p, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, pos: int, *, cache=None,
               cache_pos: Optional[int] = None):
    """One layer; returns (x, new_cache)."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps, cfg.norm_offset)
    out, new_cache = L.attention_fwd(p["attn"], cfg, h, positions,
                                     window=cfg.layer_window(pos),
                                     cache=cache, cache_pos=cache_pos)
    if cfg.post_norms:
        out = L.rms_norm(out, p["ln1_post"], cfg.rms_eps, cfg.norm_offset)
    x = x + out
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps, cfg.norm_offset)
    out = L.mlp_fwd(p["mlp"], h)
    if cfg.post_norms:
        out = L.rms_norm(out, p["ln2_post"], cfg.rms_eps, cfg.norm_offset)
    return x + out, new_cache


# ----------------------------------------------------------------------- #
# model init                                                               #
# ----------------------------------------------------------------------- #
def to_params(tree: Mapping, cfg: ModelConfig, device=None) -> Params:
    """A :class:`Params` of the reference's parameter tree (tensors or
    numpy arrays): norm weights in float32, the rest in ``cfg.dtype``."""
    dt = torch_dtype(cfg.dtype)

    def conv(name, x):
        if isinstance(x, Mapping):
            return {k: conv(k, v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(name, v) for v in x)
        return torch.as_tensor(x).to(
            device=device, dtype=torch.float32 if name in NORMS else dt)

    return Params(conv("", tree))


def init_model(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random weights from ``gen`` (a generator on ``device``), drawn as
    the reference draws them (N(0, 0.02^2), output projections scaled by
    1/sqrt(2 n_layers), norms 1, biases 0); the draws differ from JAX's."""
    check_dense(cfg)
    period = period_of(cfg)
    n_groups = cfg.n_layers // period
    return Params({
        "embed": L.init_embed(gen, cfg, device),
        "blocks": tuple(_init_block(gen, cfg, pos, n_groups, device)
                        for pos in range(period)),
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
    })


# ----------------------------------------------------------------------- #
# forward                                                                  #
# ----------------------------------------------------------------------- #
def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Tuple] = None,
            cache_pos: Optional[int] = None,
            last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tuple]]:
    """tokens: (B, T) -> (logits (B, T, V) float32, aux_loss, new_cache).
    ``cache_pos`` is a host integer: where this call's tokens start."""
    check_dense(cfg)
    dtype = torch_dtype(cfg.dtype)
    period = period_of(cfg)
    x = L.embed_fwd(params["embed"], cfg, tokens, dtype)
    t = x.shape[1]
    if positions is None:
        start = int(cache_pos) if cache_pos is not None else 0
        positions = torch.arange(start, start + t, dtype=torch.int32,
                                 device=x.device)
    n_groups = cfg.n_layers // period
    for g in range(n_groups):
        for pos in range(period):
            c = ((cache[pos][0][g], cache[pos][1][g])
                 if cache is not None else None)
            x, _ = _block_fwd(params["blocks"][pos].group(g), cfg, x,
                              positions, pos, cache=c, cache_pos=cache_pos)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.norm_offset)
    if last_only:
        x = x[:, -1:]
    logits = L.unembed_fwd(params["embed"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, cache


# ----------------------------------------------------------------------- #
# decode cache                                                             #
# ----------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None
               ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """Zeroed (k, v) per period position, stacked over groups."""
    check_dense(cfg)
    period = period_of(cfg)
    shape = (cfg.n_layers // period, batch, cfg.n_kv_heads, max_len,
             cfg.head_dim)
    return tuple((torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device))
                 for _ in range(period))
