"""Shared transformer building blocks of all ten architectures.

The counterpart of ``repro/models/layers.py``: ``rms_norm`` (``:31``),
``layer_norm`` (``:39``), ``rope`` (``:51``),
``init_attention``/``attention_fwd`` with its ``kv_override`` branch for
cross-attention (``:72-162``), ``cross_kv`` (``:165``), the SwiGLU and the
two-matrix GELU ``init_mlp``/``mlp_fwd`` (``:179-200``) and
``init_embed``/``embed_fwd``/``unembed_fwd`` (``:210-235``).  Every
product goes through :func:`repro_torch.kernels.ops.matmul`, so on the
card it runs ``csrc/gemm.cu`` (bf16 in, float32 accumulator, bf16 out), as
the reference's ``kops.matmul`` runs the Pallas gemm; attention goes
through :func:`repro_torch.kernels.ops.attention` and its kernels.

Parameters are :class:`Params` trees with the reference's names and its
``(in, out)`` weight layout.  Deliberate differences, with identical
numerics:

* for serving, weight matrices, biases and the embedding table are
  stored in ``cfg.dtype``, where the reference stores float32 and casts
  at every use (``p["wq"].astype(dt)``): the same bf16 values reach every
  product, at half the memory (18.5 GB for gemma2-9b instead of 37).
  Norm weights stay float32, since the norms read them in float32.  Every
  use still casts to the activations' dtype (``.to(dt)``, a no-op on that
  storage), so the trainer's float32 master weights
  (``Model.init(..., master=True)``) take the reference's casts and its
  gradients;
* the decode-cache write (``dynamic_update_slice``, ``:128-131``) is an
  in-place write into the caller's cache tensors, which come back as the
  new cache: a slice write at a host integer ``cache_pos``, an
  ``index_copy_`` at a one-element int32 tensor on the cache's device
  (the position of a captured decode step, never read on the host; the
  decode kernel then reads ``kv_len`` there too);
* the logit soft-cap runs in place on the float32 logits, so the
  (B, T, vocab) prefill logits exist once, not three times (training
  takes the out-of-place form, whose tanh autograd keeps);
* GELU is the tanh form (``approximate="tanh"``), JAX's default for
  ``jax.nn.gelu``; PyTorch's default is the erf form.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.kernels import ops
from repro_torch.models.sharding import (embedding, index_copy_,
                                         merge_last, shard, split_last)

#: rows generated at a time by :func:`dense_init` (bounds its float32 temp)
_INIT_ROWS = 8192

#: a cache position: a host integer, or a one-element int32 tensor on the
#: model's device (a captured decode step's)
Pos = Union[int, torch.Tensor]


def positions_from(cache_pos: Optional[Pos], t: int,
                   device) -> torch.Tensor:
    """The int32 positions ``cache_pos .. cache_pos + t - 1`` (from 0
    without a cache position), on ``device``; a tensor position is never
    read on the host."""
    if isinstance(cache_pos, torch.Tensor):
        return cache_pos.reshape(1).to(torch.int32) + torch.arange(
            t, dtype=torch.int32, device=device)
    start = int(cache_pos) if cache_pos is not None else 0
    return torch.arange(start, start + t, dtype=torch.int32, device=device)


class Params(nn.Module):
    """A tree of parameters read like the reference's dicts: ``p["wq"]``,
    ``"bq" in p``.  Nested mappings become sub-trees, tuples become
    :class:`torch.nn.ModuleList` s of sub-trees, tensors become
    parameters.  They take no gradient until ``requires_grad_()`` asks
    for one: the serving loop's weights never do, the trainer's float32
    masters do."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, Params(value))
            elif isinstance(value, (tuple, list)):
                self.add_module(name, nn.ModuleList(Params(v) for v in value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def group(self, g: int) -> Dict:
        """Views of slice ``g`` of every stacked tensor, as plain dicts."""
        out: Dict = {n: p[g] for n, p in self._parameters.items()}
        for n, m in self._modules.items():
            out[n] = m.group(g)
        return out


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               device, scale: float = 0.02, lead: Tuple[int, ...] = ()
               ) -> torch.Tensor:
    """N(0, scale^2) weights of ``lead + shape`` in ``dtype``, drawn in
    float32 (as ``layers.py:24-26``) a block of rows at a time."""
    out = torch.empty(lead + shape, dtype=dtype, device=device)
    for idx in itertools.product(*map(range, lead)):
        dst = out[idx]
        for r0 in range(0, shape[0], _INIT_ROWS):
            rows = dst[r0:r0 + _INIT_ROWS]
            rows.copy_(torch.randn(rows.shape, generator=gen, device=device,
                                   dtype=torch.float32).mul_(scale))
    return out


# ----------------------------------------------------------------------- #
# norms                                                                    #
# ----------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (w.float() + offset)).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 with the biased variance (``jnp.var``)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


# ----------------------------------------------------------------------- #
# rotary position embeddings                                               #
# ----------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, H, T, D); positions: (B, T) or (T,).  The frequencies are
    computed in float32 as the reference computes them."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device) * _rope_step(theta, half))
    if positions.dim() == 1:
        ang = positions.float()[:, None] * freqs[None, :]  # (T, half)
    else:
        ang = positions.float()[:, None, :, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_step(theta: float, half: int) -> float:
    """log(theta) / half, computed in float32 on the CPU and given to the
    device as a scalar: no host-to-device copy in the forward, which a
    captured step could not hold."""
    step = torch.log(torch.tensor(theta, dtype=torch.float32)) / half
    return float(step)


# ----------------------------------------------------------------------- #
# attention                                                                #
# ----------------------------------------------------------------------- #
def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.head_dim
    hp = cfg.padded_heads
    dt = torch_dtype(cfg.dtype)
    kw = dict(dtype=dt, device=device, lead=lead)
    p = {
        "wq": dense_init(gen, (d, hp * hd), **kw),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), **kw),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), **kw),
        "wo": dense_init(gen, (hp * hd, d),
                         scale=0.02 / (2 * cfg.n_layers) ** 0.5, **kw),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hp * hd), ("bk", cfg.n_kv_heads * hd),
                            ("bv", cfg.n_kv_heads * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dt, device=device)
    return p


def attention_fwd(p, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0,
                  causal: bool = True,
                  cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  cache_pos: Optional[Pos] = None,
                  kv_override: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                  ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Self- (or cross-) attention with an optional decode cache.

    cache: (k_cache, v_cache) each (B, Hkv, S, D), written in place at
    ``cache_pos`` (a host integer or a one-element int32 device tensor)
    and returned as the new cache.  kv_override: a
    precomputed (k, v) for cross-attention (:func:`cross_kv`); q then
    takes no rope, as in the reference."""
    t = x.shape[1]
    hq, hkv = cfg.padded_heads, cfg.n_kv_heads
    dt = x.dtype

    q = ops.matmul(x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    q = shard(split_last(q, hq).transpose(1, 2),
              "batch", "model", None, None)
    if kv_override is None:
        k = ops.matmul(x, p["wk"].to(dt))
        v = ops.matmul(x, p["wv"].to(dt))
        if "bk" in p:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        k = split_last(k, hkv).transpose(1, 2)
        v = split_last(v, hkv).transpose(1, 2)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override

    new_cache = None
    kv_len = None
    fresh_prefill = (cache is not None and cfg.prefill_fresh_kv and t > 1
                     and kv_override is None)
    if cache is not None:
        kc, vc = cache
        if isinstance(cache_pos, torch.Tensor):
            at = positions_from(cache_pos, t, kc.device)
            slots = at.long()
            index_copy_(kc, 2, slots, k.to(kc.dtype))
            index_copy_(vc, 2, slots, v.to(vc.dtype))
            end = at[-1:] + 1
        else:
            pos = int(cache_pos) if cache_pos is not None else 0
            kc[:, :, pos:pos + t] = k
            vc[:, :, pos:pos + t] = v
            end = pos + t
        new_cache = (kc, vc)
        if not fresh_prefill:
            # from-scratch prefill attends over the fresh k/v instead
            k, v = kc, vc
            kv_len = end

    chunk_q = cfg.attn_chunk_q if ((cache is None or fresh_prefill)
                                   and causal and window == 0) else 0
    out = ops.attention(q, k.to(dt), v.to(dt), causal=causal, window=window,
                        softcap=cfg.attn_softcap, kv_len=kv_len,
                        chunk_q=chunk_q)
    if hq > cfg.n_heads:
        # zero the padded heads, which sit within each KV group
        group = hq // hkv
        real = cfg.n_heads // hkv
        mask = (torch.arange(hq, device=out.device) % group < real).to(
            out.dtype)
        out = out * mask[None, :, None, None]
    out = ops.matmul(merge_last(out.transpose(1, 2)), p["wo"].to(dt))
    return shard(out, "batch", "seq", None), new_cache


def cross_kv(p, cfg: ModelConfig, enc: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V, each (B, Hkv, S_enc, D), from the encoder's
    output."""
    hkv = cfg.n_kv_heads
    k = ops.matmul(enc, p["wk"].to(enc.dtype))
    v = ops.matmul(enc, p["wv"].to(enc.dtype))
    return (split_last(k, hkv).transpose(1, 2),
            split_last(v, hkv).transpose(1, 2))


# ----------------------------------------------------------------------- #
# feed-forward                                                             #
# ----------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, cfg: ModelConfig, device,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    kw = dict(dtype=dt, device=device, lead=lead)
    if cfg.use_layernorm_gelu:       # whisper's two-matrix GELU MLP
        return {"w1": dense_init(gen, (d, ff), **kw),
                "b1": torch.zeros(lead + (ff,), dtype=dt, device=device),
                "w2": dense_init(gen, (ff, d),
                                 scale=0.02 / (2 * cfg.n_layers) ** 0.5,
                                 **kw),
                "b2": torch.zeros(lead + (d,), dtype=dt, device=device)}
    return {"wg": dense_init(gen, (d, ff), **kw),
            "wu": dense_init(gen, (d, ff), **kw),
            "wd": dense_init(gen, (ff, d),
                             scale=0.02 / (2 * cfg.n_layers) ** 0.5, **kw)}


def mlp_fwd(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if "w1" in p:
        h = ops.matmul(x, p["w1"].to(dt)) + p["b1"].to(dt)
        h = torch.nn.functional.gelu(h, approximate="tanh")
        return ops.matmul(h, p["w2"].to(dt)) + p["b2"].to(dt)
    g = ops.matmul(x, p["wg"].to(dt))
    u = ops.matmul(x, p["wu"].to(dt))
    h = shard(torch.nn.functional.silu(g) * u, "batch", "seq", "model")
    return ops.matmul(h, p["wd"].to(dt))


# ----------------------------------------------------------------------- #
# embeddings / unembedding                                                 #
# ----------------------------------------------------------------------- #
def init_embed(gen: torch.Generator, cfg: ModelConfig,
               device) -> Dict[str, torch.Tensor]:
    dt = torch_dtype(cfg.dtype)
    p = {"table": dense_init(gen, (cfg.vocab, cfg.d_model), dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt, device)
    return p


def embed_fwd(p, cfg: ModelConfig, tokens: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    x = embedding(tokens, p["table"]).to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return shard(x, "batch", "seq", None)


def unembed_fwd(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.tie_embeddings:
        logits = ops.matmul(x, p["table"].mT.to(dt))
    else:
        logits = ops.matmul(x, p["unembed"].to(dt))
    logits = logits.float()
    if cfg.final_softcap > 0:
        if logits.requires_grad:
            logits = torch.tanh(logits / cfg.final_softcap) \
                * cfg.final_softcap
        else:
            logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    return shard(logits, "batch", "seq", "model")
