"""Mamba2 SSD (state-space duality) mixer: mamba2-1.3b and jamba's layers.

The counterpart of ``repro/models/ssm.py``: ``init_ssm`` (``:39``),
``_split_proj`` (``:58``), ``_causal_conv`` (``:66``), ``ssd_fwd``
(``:91``, chunked SSD for prefill, ``return_state`` for serving),
``ssd_step`` (``:168``, O(1) per token) and ``init_ssm_state``
(``:198``).  The state (B, H, S, P), float32, is the SSM's decode cache:
O(1) in context, and the second object the serving loop places by Device
First-Use beside the KV cache.

``in_proj`` and ``out_proj`` go through :func:`repro_torch.kernels.ops.
matmul`, so on the card they run ``csrc/gemm.cu``, as the reference's run
its Pallas gemm.  The chunk contractions and the inter-chunk scan are
XLA in the reference, not Pallas: here they are float32 products of the
un-intercepted library (``ref.torch_matmul``) and a loop over chunks,
each three-operand einsum of the reference written as an elementwise
product followed by one batched product:

* ``y_intra`` (``:128-133``): ``(C B^T) * L`` per (chunk, b, head), then
  ``(i, j) @ (j, p)``;
* the chunk states (``:137-138``): ``B^T (S, q) @ (x dt decay) (q, H P)``;
* ``y_inter`` (``:151-152``): ``C (q, S) @ h (S, H P)``, then the decay.

A prompt must be a whole number of chunks (``:115``): ``ssd_fwd`` raises
``ValueError`` otherwise.  Parameters read in float32 (``a_log``,
``dt_bias``, ``d_skip``, ``norm_w``, ``conv_b``) are stored in float32,
the rest in ``cfg.dtype`` (``transformer.FLOAT32``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.kernels import ops
from repro_torch.kernels.ref import torch_matmul
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.sharding import per_shard, shard

#: chunk length of the SSD: the intra-chunk work is quadratic in it
CHUNK = 64


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d, din, s, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * s
    kw = dict(dtype=torch_dtype(cfg.dtype), device=device, lead=lead)

    def f32(values: torch.Tensor) -> torch.Tensor:
        return values.to(device).expand(lead + values.shape).clone()

    return {
        # zxbcdt projection: [z(din) | x(din) | B(s) | C(s) | dt(h)]
        "in_proj": dense_init(gen, (d, 2 * din + 2 * s + h), **kw),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim), scale=0.1, **kw),
        "conv_b": f32(torch.zeros(conv_dim)),
        "a_log": f32(torch.log(torch.arange(1, h + 1,
                                            dtype=torch.float32))),
        "dt_bias": f32(torch.zeros(h)),
        "d_skip": f32(torch.ones(h)),
        "norm_w": f32(torch.ones(din)),
        "out_proj": dense_init(gen, (din, d),
                               scale=0.02 / (2 * cfg.n_layers) ** 0.5, **kw),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din, s = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * s],
            zxbcdt[..., 2 * din + 2 * s:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along T.  xbc: (B, T, C).  With ``state``
    (B, K-1, C), decode mode: returns (out, new_state); else (out, None).
    Mixed dtypes promote as in the reference (``jnp.concatenate``)."""
    ksize, t = w.shape[0], xbc.shape[1]
    if state is not None:
        window = torch.cat([state, xbc], dim=1)          # (B, K-1+T, C)
        new_state = window[:, -(ksize - 1):]
    else:
        # zeros, then concatenation, as the reference builds it
        # (``F.pad`` of a sharded DTensor fails on torch 2.11)
        window = torch.cat([xbc.new_zeros((xbc.shape[0], ksize - 1,
                                           xbc.shape[2])), xbc], dim=1)
        new_state = None
    out = torch.zeros_like(xbc)
    for i in range(ksize):
        out = out + window[:, i:i + t] * w[i].to(xbc.dtype)
    return F.silu(out + b.to(xbc.dtype)), new_state


def _ssd_chunks(xh: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan, float32.  xh (B, T, H, P), bmat and cmat
    (B, T, S), dt (B, T, H) -> (y (B, T, H, P), the state after the last
    position (B, S, H, P))."""
    bsz, t, h, hp = xh.shape
    s = bmat.shape[-1]
    nc = t // q

    def chunks(v):  # (B, T, ...) -> (nc, B, q, ...)
        return v.reshape((bsz, nc, q) + v.shape[2:]).transpose(0, 1)

    xc = chunks(xh)                                           # (.,q,H,P)
    bc = chunks(bmat)                                         # (nc,B,q,S)
    cc = chunks(cmat)                                         # (nc,B,q,S)
    dtc = chunks(dt)                                          # (nc,B,q,H)
    cum = torch.cumsum(dtc * a, dim=2)                        # (nc,B,q,H)
    xdt = xc * dtc[..., None]                                 # (nc,B,q,H,P)

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, per head
    cum_h = cum.transpose(2, 3)                               # (nc,B,H,q)
    lmat = torch.exp(cum_h[..., :, None] - cum_h[..., None, :])
    upper = ~torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    cb = torch_matmul(cc, bc.transpose(-1, -2))               # (nc,B,q,q)
    # out of place: in training, exp's backward reads lmat
    lmat = lmat.masked_fill(upper, 0.0) * cb[:, :, None]
    y_intra = torch_matmul(lmat, xdt.transpose(2, 3)).transpose(2, 3)

    # chunk states, (nc, B, S, H, P): sum_j B_j exp(cum_last - cum_j) x_j dt_j
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)            # (nc,B,q,H)
    states = torch_matmul(
        bc.transpose(-1, -2),
        (xdt * decay_to_end[..., None]).reshape(nc, bsz, q, h * hp)
    ).view(nc, bsz, s, h, hp)

    # inter-chunk scan over the running state
    seg_decay = torch.exp(cum[:, :, -1])[:, :, None, :, None]  # (nc,B,1,H,1)
    hcur = torch.zeros_like(states[0])
    hprevs = torch.empty_like(states)
    for n in range(nc):
        hprevs[n] = hcur
        hcur = hcur * seg_decay[n] + states[n]
    # the carried state's contribution to each position of the chunk
    y_inter = torch_matmul(cc, hprevs.view(nc, bsz, s, h * hp)).view(
        nc, bsz, q, h, hp) * torch.exp(cum)[..., None]

    y = y_intra + y_inter + xc * d_skip[:, None]
    return y.transpose(0, 1).reshape(bsz, t, h, hp), hcur


def _ssd_core(fn, *xs, a: torch.Tensor, d_skip: torch.Tensor, **kw):
    """``fn`` on each batch shard (``sharding.per_shard``: under a mesh's
    dry run every rank scans its batch rows over all heads; the products
    of a scan have no DTensor rule); ``a`` and ``d_skip`` whole, their
    gradients summed over the batch shards."""
    return per_shard(functools.partial(fn, **kw), *xs, shardable=(0,),
                     a=a, d_skip=d_skip)


def ssd_fwd(p, cfg: ModelConfig, xin: torch.Tensor, chunk: int = CHUNK,
            return_state: bool = False):
    """Chunked SSD.  xin: (B, T, d) -> (B, T, d); with ``return_state``
    also (ssm_h (B, H, S, P) float32, conv_state (B, K-1, C)) after the
    last position: the prefill of a decode cache."""
    bsz, t, _ = xin.shape
    din, s, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = cfg.ssm_head_dim
    q = min(chunk, t)
    if t % q:
        raise ValueError(f"ssd_fwd: {t} positions are not a whole number "
                         f"of chunks of {q}")

    zxbcdt = ops.matmul(xin, p["in_proj"].to(xin.dtype))
    z, xbc, dtp = _split_proj(cfg, zxbcdt)
    raw_xbc = xbc
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    dt = F.softplus(dtp.float() + p["dt_bias"])               # (B,T,H)
    a = -torch.exp(p["a_log"])                                # (H,)
    xh = shard(xbc[..., :din].reshape(bsz, t, h, hp).float(),
               "batch", None, "model", None)                  # (B,T,H,P)
    y, hcur = _ssd_core(_ssd_chunks, xh, xbc[..., din:din + s].float(),
                        xbc[..., din + s:].float(), dt, a=a,
                        d_skip=p["d_skip"], q=q)
    y = y.reshape(bsz, t, din).to(xin.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.rms_eps)
    out = ops.matmul(y, p["out_proj"].to(y.dtype))
    if return_state:
        conv_state = raw_xbc[:, -(cfg.ssm_conv - 1):, :]
        return out, (hcur.transpose(1, 2), conv_state)
    return out


def _ssd_update(ssm_h: torch.Tensor, xh: torch.Tensor, bvec: torch.Tensor,
                cvec: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                d_skip: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's state update, float32.  ssm_h (B, H, S, P), xh
    (B, H, P), bvec and cvec (B, S), dt (B, H) -> (y (B, H, P), the new
    state)."""
    decay = torch.exp(dt * a)                                  # (B,H)
    upd = bvec[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]
    ssm_h = ssm_h * decay[..., None, None] + upd               # (B,H,S,P)
    y = torch_matmul(cvec[:, None, None, :], ssm_h)[:, :, 0]   # (B,H,P)
    return y + xh * d_skip[None, :, None], ssm_h


def ssd_step(p, cfg: ModelConfig, xin: torch.Tensor,
             state: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token decode.  xin: (B, 1, d); state = (ssm_h, conv_state).
    Returns the output and the new state (new tensors)."""
    bsz = xin.shape[0]
    din, s, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = cfg.ssm_head_dim
    ssm_h, conv_state = state

    zxbcdt = ops.matmul(xin, p["in_proj"].to(xin.dtype))
    z, xbc, dtp = _split_proj(cfg, zxbcdt)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state=conv_state)
    dt = F.softplus(dtp[:, 0].float() + p["dt_bias"])          # (B,H)
    a = -torch.exp(p["a_log"])
    xh = xbc[:, 0, :din].reshape(bsz, h, hp).float()           # (B,H,P)
    y, ssm_h = _ssd_core(_ssd_update, ssm_h, xh,
                         xbc[:, 0, din:din + s].float(),
                         xbc[:, 0, din + s:].float(), dt, a=a,
                         d_skip=p["d_skip"])
    y = y.reshape(bsz, 1, din).to(xin.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.rms_eps)
    return ops.matmul(y, p["out_proj"].to(y.dtype)), (ssm_h, conv_state)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None, lead: Tuple[int, ...] = ()
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (ssm_h float32 (B, H, S, P), conv_state ``dtype``
    (B, K-1, C)), each with ``lead`` dims in front, allocated whole:
    never an expanded view, since the cache is written in place."""
    h, s, hp = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * s
    return (torch.zeros(lead + (batch, h, s, hp), dtype=torch.float32,
                        device=device),
            torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                        dtype=dtype, device=device))

