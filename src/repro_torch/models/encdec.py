"""Whisper-tiny backbone: the encoder-decoder transformer.

The counterpart of ``repro/models/encdec.py``.  The audio conv frontend
is a stub, as in the reference: callers supply precomputed frame
embeddings (B, S_enc, d).  Downstream of it: a pre-LN encoder with
sinusoidal positions and bidirectional attention, and a pre-LN decoder
with learned positions (``pos_dec``, 4096 rows), causal self-attention,
cross-attention over the encoder's output and the two-matrix GELU MLP.

As in the reference, every attention applies ``rope``: the encoder's at
positions 0 (the identity), the decoder's self-attention on top of
``pos_dec``; cross-attention's queries take none.  This is the
reference's model, not OpenAI's Whisper, which has no rope.

Parameters are stacked over layers (``enc`` and ``dec``, as the
reference's ``vmap`` stacks them) and a Python loop reads views of them,
as ``models/transformer.py`` does.  The decode cache is
``(self_kv, cross_kv)``, each a ``(k, v)`` pair stacked over decoder
layers: ``(n_layers, B, Hkv, max_len, D)`` and ``(n_layers, B, Hkv,
encoder_seq, D)``.  The self K/V is written in place.  A forward given
``frames`` (or ``enc_out``) with a cache computes each layer's cross K/V
afresh, and the fresh pair *replaces* the placeholder in the returned
cache, in the model's dtype, as the reference's scan returns it
(``encdec.py:106,115``); a decode step reads it back from ``cache[1]``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.layers import Params
from repro_torch.models.sharding import shard

#: rows of the decoder's learned position table (``encdec.py:56``)
POS_ROWS = 4096


def _sinusoid(t: int, d: int, device=None) -> torch.Tensor:
    """(t, d) float32: sines of the first half, cosines of the second."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    # made on the device, not copied there: a captured train step holds
    # no copy from pageable host memory
    step = torch.log(torch.full((), 10000.0, device=device)) / (d // 2 - 1)
    inv = torch.exp(-dim * step)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln(cfg: ModelConfig, lead: Tuple[int, ...], device) -> Dict:
    shape = lead + (cfg.d_model,)
    return {"w": torch.ones(shape, dtype=torch.float32, device=device),
            "b": torch.zeros(shape, dtype=torch.float32, device=device)}


def init_model(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random weights from ``gen`` (a generator on ``device``), drawn as
    the reference draws them (``layers.init_*``, ``pos_dec`` at scale
    0.01, LayerNorms 1 and 0); the draws differ from JAX's."""
    enc, dec = (cfg.encoder_layers,), (cfg.n_layers,)
    return Params({
        "embed": L.init_embed(gen, cfg, device),
        "pos_dec": L.dense_init(gen, (POS_ROWS, cfg.d_model),
                                torch_dtype(cfg.dtype), device, scale=0.01),
        "enc": {"ln1": _ln(cfg, enc, device),
                "attn": L.init_attention(gen, cfg, device, lead=enc),
                "ln2": _ln(cfg, enc, device),
                "mlp": L.init_mlp(gen, cfg, device, lead=enc)},
        "dec": {"ln1": _ln(cfg, dec, device),
                "attn": L.init_attention(gen, cfg, device, lead=dec),
                "lnx": _ln(cfg, dec, device),
                "xattn": L.init_attention(gen, cfg, device, lead=dec),
                "ln2": _ln(cfg, dec, device),
                "mlp": L.init_mlp(gen, cfg, device, lead=dec)},
        "ln_enc": _ln(cfg, (), device),
        "ln_dec": _ln(cfg, (), device),
    })


def _norm(x: torch.Tensor, p) -> torch.Tensor:
    return L.layer_norm(x, p["w"], p["b"])


def _enc_layer_fwd(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros(x.shape[1], dtype=torch.int32, device=x.device)
    out, _ = L.attention_fwd(p["attn"], cfg, _norm(x, p["ln1"]), zeros,
                             causal=False)
    x = x + out
    return shard(x + L.mlp_fwd(p["mlp"], _norm(x, p["ln2"])),
                 "batch", "seq", None)


def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: the stub frontend's (B, S_enc, d) embeddings."""
    dtype = torch_dtype(cfg.dtype)
    frames = frames.to(device=params["pos_dec"].device)
    x = frames.to(dtype) + _sinusoid(frames.shape[1], cfg.d_model,
                                     frames.device).to(dtype)
    for g in range(cfg.encoder_layers):
        x = _enc_layer_fwd(params["enc"].group(g), cfg, x)
    return _norm(x, params["ln_enc"])


def _dec_layer_fwd(p, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, enc: Optional[torch.Tensor],
                   cache, cache_pos: Optional[L.Pos]):
    """One decoder layer; returns (x, this layer's cross K/V)."""
    out, _ = L.attention_fwd(p["attn"], cfg, _norm(x, p["ln1"]), positions,
                             cache=cache[0] if cache is not None else None,
                             cache_pos=cache_pos)
    x = x + out
    # train/prefill: compute the cross K/V; decode: reuse the prefill's
    kv = L.cross_kv(p["xattn"], cfg, enc) if enc is not None else cache[1]
    out, _ = L.attention_fwd(p["xattn"], cfg, _norm(x, p["lnx"]), positions,
                             causal=False, kv_override=kv)
    x = x + out
    return shard(x + L.mlp_fwd(p["mlp"], _norm(x, p["ln2"])),
                 "batch", "seq", None), kv


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None,
            cache: Optional[Tuple] = None,
            cache_pos: Optional[L.Pos] = None,
            last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tuple]]:
    """The decoder's forward: (logits (B, T, V) float32, aux 0, new
    cache).  Give ``frames`` (training, prefill) or a ``cache`` holding
    the cross K/V (decode).  ``cache_pos`` is a host integer or a
    one-element int32 tensor on the model's device (a captured decode
    step's position, never read on the host)."""
    dtype = torch_dtype(cfg.dtype)
    if enc_out is None and frames is not None:
        enc_out = encode(params, cfg, frames)
    x = L.embed_fwd(params["embed"], cfg, tokens, dtype)
    positions = L.positions_from(cache_pos, tokens.shape[1], x.device)
    x = x + params["pos_dec"][positions].to(dtype)
    fresh = []
    for g in range(cfg.n_layers):
        lc = (tuple(tuple(leaf[g] for leaf in pair) for pair in cache)
              if cache is not None else None)
        x, kv = _dec_layer_fwd(params["dec"].group(g), cfg, x, positions,
                               enc_out, lc, cache_pos)
        fresh.append(kv)
    new_cache = None
    if cache is not None:
        cross = cache[1]
        if enc_out is not None:
            cross = tuple(torch.stack(leaves) for leaves in zip(*fresh))
        new_cache = (cache[0], cross)
    x = _norm(x, params["ln_dec"])
    if last_only:
        x = x[:, -1:]
    logits = L.unembed_fwd(params["embed"], cfg, x)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=x.device), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None
               ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """Zeroed ``(self_kv, cross_kv)``, each ``(k, v)`` stacked over the
    decoder's layers; four separate tensors (the reference's tuples
    repeat one immutable array), since the self K/V is written in
    place."""
    nl, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def pair(length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = (nl, batch, hkv, length, hd)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    return (pair(max_len), pair(cfg.encoder_seq))

