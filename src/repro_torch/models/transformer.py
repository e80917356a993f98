"""Decoder-only LM assembly: the dense, MoE, SSM, hybrid and VLM
families.

The counterpart of ``repro/models/transformer.py``: ``period_of``,
``_init_block``/``_block_fwd``, ``init_model``, ``forward`` and
``init_cache``, in the reference's stacked layout.  Layers are grouped by
the repeat period (2 for gemma2's local/global alternation and
every-other-layer MoE, 8 for jamba's 7:1 mamba:attention interleave, else
1); every parameter of period position ``pos`` is stacked over the
``n_groups = n_layers // period`` groups.  Layer ``g * period + pos`` reads
group ``g`` at position ``pos``: an attention (``layers.attention_fwd``)
or SSD (``ssm``) mixer, then an MLP or MoE (``moe``) feed-forward.

The decode cache is a tuple over period positions of ``(k, v)``, each
``(n_groups, B, Hkv, S, D)``, at attention positions and of ``(ssm_h,
conv_state)`` at SSD positions: ``ssm_h`` float32 ``(n_groups, B, H, S,
P)``, ``conv_state`` ``(n_groups, B, K-1, C)`` in the cache dtype.

The reference drives the stack with ``jax.lax.scan``; here it is a
Python loop over the layers, reading views of the stacked tensors.  Each
layer's output, the residual stream, is constrained to the batch
(``sharding.shard``, the identity without a mesh): under a mesh's dry run
DTensor places each op from its inputs' placements, where GSPMD solves
the whole program, and without the constraint each layer would start
from the last one's (partial) sums and count differently.  The
cache is written in place (attention's slice write, the SSD's ``copy_``
of its new state) and the same tuple comes back as the new cache.  A VLM
config (pixtral-12b) prepends the stub frontend's ``patch_embeds`` to the
token embeddings, as the reference does: the prefix takes cache slots
and positions, and its rows are dropped before the vocab head.  The
enc-dec family (whisper-tiny) is ``models/encdec.py``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import Params
from repro_torch.models.sharding import shard

#: parameter names that stay float32: norm weights (the enc-dec
#: LayerNorms' ``w`` and ``b`` below them), and the SSD's parameters that
#: the reference reads in float32 (``ssm.py:108-110, 152-155``)
NORMS = frozenset({"ln1", "ln2", "ln1_post", "ln2_post", "final_norm",
                   "lnx", "ln_enc", "ln_dec"})
FLOAT32 = NORMS | {"a_log", "dt_bias", "d_skip", "norm_w", "conv_b"}


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
    """Period position ``pos``, stacked over ``n_groups``: the mixer
    (attention or SSD), the feed-forward (MLP or MoE) and the norms."""
    ones = torch.ones((n_groups, cfg.d_model), dtype=torch.float32,
                      device=device)
    p = {"ln1": ones, "ln2": ones.clone()}
    if cfg.post_norms:
        p["ln1_post"] = ones.clone()
        p["ln2_post"] = ones.clone()
    lead = (n_groups,)
    if cfg.is_attn_layer(pos):
        p["attn"] = L.init_attention(gen, cfg, device, lead=lead)
    else:
        p["ssm"] = S.init_ssm(gen, cfg, device, lead=lead)
    if cfg.is_moe_layer(pos):
        p["moe"] = M.init_moe(gen, cfg, device, lead=lead)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, device, lead=lead)
    return p


def _ssd_fwd(p, cfg: ModelConfig, h: torch.Tensor, cache):
    """The SSD mixer's three branches (``transformer.py:73-82``): a decode
    step, a prefill into a cache, no cache.  The new state is copied into
    the cache's tensors, which come back as the new cache."""
    if cache is None:
        return S.ssd_fwd(p, cfg, h), None
    if h.shape[1] == 1:
        out, state = S.ssd_step(p, cfg, h, cache)
    else:
        out, state = S.ssd_fwd(p, cfg, h, return_state=True)
    for dst, src in zip(cache, state):
        dst.copy_(src)
    return out, cache


def _block_fwd(p, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, pos: int, *, cache=None,
               cache_pos: Optional[L.Pos] = None,
               moe_impl: str = "scatter"):
    """One layer; returns (x, aux, new_cache)."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps, cfg.norm_offset)
    if cfg.is_attn_layer(pos):
        out, new_cache = L.attention_fwd(p["attn"], cfg, h, positions,
                                         window=cfg.layer_window(pos),
                                         cache=cache, cache_pos=cache_pos)
    else:
        out, new_cache = _ssd_fwd(p["ssm"], cfg, h, cache)
    if cfg.post_norms:
        out = L.rms_norm(out, p["ln1_post"], cfg.rms_eps, cfg.norm_offset)
    x = x + out
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps, cfg.norm_offset)
    aux = None
    if cfg.is_moe_layer(pos):
        out, aux = M.moe_fwd(p["moe"], cfg, h, impl=moe_impl)
    else:
        out = L.mlp_fwd(p["mlp"], h)
    if cfg.post_norms:
        out = L.rms_norm(out, p["ln2_post"], cfg.rms_eps, cfg.norm_offset)
    return shard(x + out, "batch", "seq", None), aux, new_cache


# ----------------------------------------------------------------------- #
# model init                                                               #
# ----------------------------------------------------------------------- #
def to_params(tree: Mapping, cfg: ModelConfig, device=None,
              master: bool = False) -> Params:
    """A :class:`Params` of the reference's parameter tree (tensors or
    numpy arrays): :data:`FLOAT32` (and everything under a norm) in
    float32, the rest in ``cfg.dtype``; with ``master``, every leaf in
    float32 and taking a gradient, as the trainer keeps them."""
    dt = torch.float32 if master else torch_dtype(cfg.dtype)

    def conv(name, x, f32=False):
        if isinstance(x, Mapping):
            return {k: conv(k, v, f32 or k in NORMS) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(name, v, f32) for v in x)
        return torch.as_tensor(x).to(
            device=device,
            dtype=torch.float32 if f32 or name in FLOAT32 else dt)

    return Params(conv("", tree)).requires_grad_(master)


def init_model(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random weights from ``gen`` (a generator on ``device``), drawn as
    the reference draws them (N(0, 0.02^2), output projections scaled by
    1/sqrt(2 n_layers), norms 1, biases 0, the SSD's float32 parameters
    as ``ssm.init_ssm``); the draws differ from JAX's."""
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
            patch_embeds: Optional[torch.Tensor] = None,
            cache: Optional[Tuple] = None,
            cache_pos: Optional[L.Pos] = None,
            moe_impl: str = "scatter",
            last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tuple]]:
    """tokens: (B, T) -> (logits (B, T, V) float32, aux_loss, new_cache).
    ``cache_pos`` is where this call's tokens start: a host integer, or
    a one-element int32 tensor on the model's device, as the reference
    takes a traced ``jnp.int32`` (a captured decode step's position,
    never read on the host).
    ``aux_loss`` is the MoE layers' router loss, summed over layers.
    ``patch_embeds`` (B, P, d), a VLM's stub frontend output, go before
    the tokens; the logits then cover the T text positions only."""
    dtype = torch_dtype(cfg.dtype)
    period = period_of(cfg)
    x = L.embed_fwd(params["embed"], cfg, tokens, dtype)
    n_patch = 0
    if patch_embeds is not None:
        n_patch = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(device=x.device, dtype=dtype), x],
                      dim=1)
    t = x.shape[1]
    if positions is None:
        positions = L.positions_from(cache_pos, t, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_groups = cfg.n_layers // period
    for g in range(n_groups):
        for pos in range(period):
            c = (tuple(leaf[g] for leaf in cache[pos])
                 if cache is not None else None)
            x, a, _ = _block_fwd(params["blocks"][pos].group(g), cfg, x,
                                 positions, pos, cache=c,
                                 cache_pos=cache_pos, moe_impl=moe_impl)
            if a is not None:
                aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.norm_offset)
    if n_patch:
        x = x[:, n_patch:]
    if last_only:
        x = x[:, -1:]
    logits = L.unembed_fwd(params["embed"], cfg, x)
    return logits, aux, cache


# ----------------------------------------------------------------------- #
# decode cache                                                             #
# ----------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None
               ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """Zeroed state per period position, stacked over groups: (k, v) in
    ``dtype`` at attention positions, (ssm_h float32, conv_state in
    ``dtype``) at SSD positions.  Every tensor is allocated whole, never
    an expanded view: the forward writes the cache in place."""
    period = period_of(cfg)
    n_groups = cfg.n_layers // period
    cache = []
    for pos in range(period):
        if cfg.is_attn_layer(pos):
            shape = (n_groups, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
            cache.append((torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device)))
        else:
            cache.append(S.init_ssm_state(cfg, batch, dtype, device,
                                          lead=(n_groups,)))
    return tuple(cache)
