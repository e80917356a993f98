"""Mixture-of-Experts layer (granite-moe, moonshot, jamba).

The counterpart of ``repro/models/moe.py``: ``init_moe`` (``:32``),
``_route`` (``:45``), ``_expert_ffn`` (``:62``) and ``moe_fwd``
(``:71``), with its two plans behind one parameter layout:

* ``scatter`` (the default): top-k routing with capacity-bounded scatter
  into per-expert buffers, batched expert products, gather and combine;
* ``dense``: every expert on every token, probability-weighted: O(E)
  work, the routing oracle of the tests.

Every product goes through :func:`repro_torch.kernels.ops.matmul`, so on
the card it runs ``csrc/gemm.cu``: the router product, and each of the
three expert products ``(E, C, d) @ (E, d, ff)`` as one batched launch,
never a loop over experts.  ``impl="a2a"`` runs ``scatter``, as the
reference does when no mesh is bound (``:72-78``); the expert-parallel
plan itself (``moe_fwd_a2a``, ``_dispatch_local``) waits for sharding
(ROADMAP Queue 1 item 11(d)).

Deliberate differences, with identical results:

* top-k is the first k of a stable descending sort, so that among equal
  probabilities the lower expert index comes first, as ``jax.lax.top_k``
  orders them (``torch.topk`` does not promise that order);
* the scatter ``buf.at[dest].add`` is ``index_add_``; every kept token
  has its own row, so the sum is exact, and the dropped ones meet in the
  spare row ``E * cap``, which is never read;
* an ``impl`` outside :data:`IMPLS` raises ``ValueError``, where the
  reference runs ``scatter`` for any name but ``dense`` and ``a2a``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

#: the plans of :func:`moe_fwd`
IMPLS = ("scatter", "dense", "a2a")


def init_moe(gen: torch.Generator, cfg: ModelConfig, device,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    kw = dict(dtype=torch_dtype(cfg.dtype), device=device, lead=lead)
    return {
        "router": dense_init(gen, (d, e), **kw),
        "wg": dense_init(gen, (e, d, ff), **kw),
        "wu": dense_init(gen, (e, d, ff), **kw),
        "wd": dense_init(gen, (e, ff, d),
                         scale=0.02 / (2 * cfg.n_layers) ** 0.5, **kw),
    }


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, ties broken
    toward the lower index, as ``jax.lax.top_k`` breaks them."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _route(p, cfg: ModelConfig, xf: torch.Tensor):
    """Router probabilities and the aux loss.  xf: (N, d)."""
    logits = ops.matmul(xf, p["router"].to(xf.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    weights, idx = top_k(probs, cfg.top_k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch aux loss: encourages uniform expert load
    e = cfg.n_experts
    frac_tokens = torch.bincount(idx[:, 0], minlength=e).float() \
        / idx.shape[0]                                # primary assignment
    mean_prob = probs.mean(0)
    aux = e * torch.sum(frac_tokens * mean_prob) * cfg.router_aux_coef
    return weights, idx, aux


def _expert_ffn(p, xe: torch.Tensor) -> torch.Tensor:
    """Batched expert SwiGLU, one launch per product.  xe: (E, C, d)."""
    dt = xe.dtype
    g = ops.matmul(xe, p["wg"].to(dt))
    u = ops.matmul(xe, p["wu"].to(dt))
    return ops.matmul(F.silu(g) * u, p["wd"].to(dt))


def capacity(cfg: ModelConfig, n: int) -> int:
    """Slots per expert for ``n`` tokens (``moe.py:95-96``): 8 at least,
    ``n`` at most."""
    cap = int(math.ceil(cfg.top_k * n * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, min(cap, n))


def dispatch(cfg: ModelConfig, idx: torch.Tensor, cap: int) -> torch.Tensor:
    """Each (token, choice)'s row in the (E * cap + 1)-row buffer: its
    expert's block at its arrival rank, or the spare row ``E * cap`` past
    the capacity (first come, first kept).  idx: (N, k) -> (N * k,)."""
    e = cfg.n_experts
    flat_e = idx.reshape(-1)
    nk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(nk, device=idx.device) - starts[flat_e[order]]
    pos_in_e = torch.empty_like(ranks)
    pos_in_e[order] = ranks
    return torch.where(pos_in_e < cap, flat_e * cap + pos_in_e, e * cap)


def moe_fwd(p, cfg: ModelConfig, x: torch.Tensor, impl: str = "scatter"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss)."""
    if impl not in IMPLS:
        raise ValueError(f"moe_fwd: impl {impl!r} not in {IMPLS}")
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    weights, idx, aux = _route(p, cfg, xf)
    e, k = cfg.n_experts, cfg.top_k

    if impl == "dense":
        h = _expert_ffn(p, xf.expand(e, n, d))              # (E, N, d)
        onehot = F.one_hot(idx, e).float()                  # (N, k, E)
        comb = (onehot * weights[..., None]).sum(1)         # (N, E)
        out = (h.float() * comb.mT[..., None]).sum(0)
        return out.reshape(b, t, d).to(x.dtype), aux

    cap = capacity(cfg, n)
    dest = dispatch(cfg, idx, cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, dest, xf.repeat_interleave(k, dim=0))
    h = _expert_ffn(p, buf[:e * cap].view(e, cap, d))       # (E, C, d)
    hflat = torch.cat([h.reshape(e * cap, d), h.new_zeros((1, d))])
    gathered = hflat[dest].reshape(n, k, d).float()
    out = (gathered * weights[..., None]).sum(1)
    return out.reshape(b, t, d).to(x.dtype), aux

