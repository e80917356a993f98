"""Shared transformer building blocks of the dense family.

The counterpart of ``repro/models/layers.py``: ``rms_norm`` (``:31``),
``rope`` (``:51``), ``init_attention``/``attention_fwd`` (``:72-162``),
the SwiGLU ``init_mlp``/``mlp_fwd`` (``:179-207``) and
``init_embed``/``embed_fwd``/``unembed_fwd`` (``:210-235``).  Every
product goes through :func:`repro_torch.kernels.ops.matmul`, so on the
card it runs ``csrc/gemm.cu`` (bf16 in, float32 accumulator, bf16 out), as
the reference's ``kops.matmul`` runs the Pallas gemm; attention goes
through :func:`repro_torch.kernels.ops.attention` and its kernels.

Parameters are :class:`Params` trees with the reference's names and its
``(in, out)`` weight layout.  Deliberate differences, with identical
numerics:

* weight matrices, biases and the embedding table are stored in
  ``cfg.dtype``, where the reference stores float32 and casts at every use
  (``p["wq"].astype(dt)``): the same bf16 values reach every product, at
  half the memory (18.5 GB for gemma2-9b instead of 37).  Norm weights stay
  float32, since :func:`rms_norm` reads them in float32;
* the decode-cache write (``dynamic_update_slice``, ``:128-131``) is an
  in-place slice write into the caller's cache tensors, which come back
  as the new cache;
* the logit soft-cap runs in place on the float32 logits, so the
  (B, T, vocab) prefill logits exist once, not three times;
* ``shard(...)`` annotations are dropped: one card has no mesh.
  ``layer_norm``, the GELU MLP and ``cross_kv`` wait for the enc-dec
  family (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import itertools
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.kernels import ops

#: rows generated at a time by :func:`dense_init` (bounds its float32 temp)
_INIT_ROWS = 8192


class Params(nn.Module):
    """A tree of parameters read like the reference's dicts: ``p["wq"]``,
    ``"bq" in p``.  Nested mappings become sub-trees, tuples become
    :class:`torch.nn.ModuleList` s of sub-trees, tensors become
    parameters that take no gradient (the port serves, it does not
    train)."""

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


# ----------------------------------------------------------------------- #
# rotary position embeddings                                               #
# ----------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, H, T, D); positions: (B, T) or (T,).  The frequencies are
    computed in float32 as the reference computes them."""
    d = x.shape[-1]
    half = d // 2
    step = (torch.log(torch.tensor(theta, dtype=torch.float32))
            / half).to(x.device)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device) * step)
    if positions.dim() == 1:
        ang = positions.float()[:, None] * freqs[None, :]  # (T, half)
    else:
        ang = positions.float()[:, None, :, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


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
                  cache_pos: Optional[int] = None,
                  ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Self-attention with an optional decode cache.

    cache: (k_cache, v_cache) each (B, Hkv, S, D), written in place at
    ``cache_pos`` and returned as the new cache."""
    b, t, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.padded_heads, cfg.n_kv_heads
    dt = x.dtype

    q = ops.matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, t, hq, hd).transpose(1, 2)
    k = ops.matmul(x, p["wk"])
    v = ops.matmul(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    k = k.reshape(b, t, hkv, hd).transpose(1, 2)
    v = v.reshape(b, t, hkv, hd).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    kv_len = None
    fresh_prefill = cache is not None and cfg.prefill_fresh_kv and t > 1
    if cache is not None:
        kc, vc = cache
        pos = int(cache_pos) if cache_pos is not None else 0
        kc[:, :, pos:pos + t] = k
        vc[:, :, pos:pos + t] = v
        new_cache = (kc, vc)
        if not fresh_prefill:
            # from-scratch prefill attends over the fresh k/v instead
            k, v = kc, vc
            kv_len = pos + t

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
    out = out.transpose(1, 2).reshape(b, t, hq * hd)
    return ops.matmul(out, p["wo"]), new_cache


# ----------------------------------------------------------------------- #
# feed-forward                                                             #
# ----------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, cfg: ModelConfig, device,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(dtype=torch_dtype(cfg.dtype), device=device, lead=lead)
    return {"wg": dense_init(gen, (d, ff), **kw),
            "wu": dense_init(gen, (d, ff), **kw),
            "wd": dense_init(gen, (ff, d),
                             scale=0.02 / (2 * cfg.n_layers) ** 0.5, **kw)}


def mlp_fwd(p, x: torch.Tensor) -> torch.Tensor:
    g = ops.matmul(x, p["wg"])
    u = ops.matmul(x, p["wu"])
    return ops.matmul(torch.nn.functional.silu(g) * u, p["wd"])


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
    x = p["table"][tokens].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def unembed_fwd(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = ops.matmul(x, p["table"].mT)
    else:
        logits = ops.matmul(x, p["unembed"])
    logits = logits.float()
    if cfg.final_softcap > 0:
        logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    return logits
