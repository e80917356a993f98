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
never a loop over experts.  ``impl="a2a"`` is the explicit expert-parallel
plan (``moe_fwd_a2a``, ``_dispatch_local``, reference ``:133-225``) when
an axis env with a mesh is bound and the experts divide over its model
dim; otherwise it runs ``scatter``, as the reference does (``:72-78``).

Under a mesh's dry run (DTensor activations) the router's sort, the
dispatch's ``index_add_`` and the combine's gather have no DTensor rule:
the tokens and the router are gathered first (``sharding.replicated``,
the collective GSPMD would insert) and routed on every rank's full copy,
with the reference's global capacity; the expert products stay sharded
over ``model`` (the constraints of ``:66, 118``), and their output is
gathered before the combine.

Deliberate differences, with identical results:

* top-k is the first k of a stable descending sort, so that among equal
  probabilities the lower expert index comes first, as ``jax.lax.top_k``
  orders them (``torch.topk`` does not promise that order);
* the scatter ``buf.at[dest].add`` is ``index_add_``; every kept token
  has its own row, so the sum is exact, and the dropped ones meet in the
  spare row ``E * cap``, which is never read;
* an ``impl`` outside :data:`IMPLS` raises ``ValueError``, where the
  reference runs ``scatter`` for any name but ``dense`` and ``a2a``;
* the load counts are ``index_add_`` into E slots, where ``bincount``
  would do, since fake tensors (the dry run) cannot shape its output.

One difference changes a result: the a2a plan regroups the received
(sender, expert) blocks expert-major before the experts' FFN, and back
after it.  The reference reshapes them without that transpose
(``:198, 205-207``), which pairs tokens with the wrong experts and ranks
once a rank holds more than one expert; the two agree where each rank
holds one, and on one rank.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.models.sharding import (block, get_env, is_dtensor,
                                         mesh_sizes, replicated, shard,
                                         unblock)

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
    frac_tokens = counts(idx[:, 0], e).float() \
        / idx.shape[0]                                # primary assignment
    mean_prob = probs.mean(0)
    aux = e * torch.sum(frac_tokens * mean_prob) * cfg.router_aux_coef
    return weights, idx, aux


def _expert_ffn(p, xe: torch.Tensor) -> torch.Tensor:
    """Batched expert SwiGLU, one launch per product.  xe: (E, C, d)."""
    dt = xe.dtype
    g = ops.matmul(xe, p["wg"].to(dt))
    u = ops.matmul(xe, p["wu"].to(dt))
    h = shard(F.silu(g) * u, "model", None, None)
    return ops.matmul(h, p["wd"].to(dt))


def _on_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """A full local tensor as a DTensor replicated over ``mesh`` (none:
    ``x`` itself)."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def counts(flat: torch.Tensor, e: int) -> torch.Tensor:
    """How many of ``flat`` name each of ``e`` experts (``bincount`` with
    a fixed length, which fake tensors can shape)."""
    return torch.zeros(e, dtype=torch.long, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))


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
    counts_e = counts(flat_e, e)
    starts = torch.cumsum(counts_e, 0) - counts_e
    ranks = torch.arange(nk, device=idx.device) - starts[flat_e[order]]
    pos_in_e = torch.empty_like(ranks)
    pos_in_e[order] = ranks
    return torch.where(pos_in_e < cap, flat_e * cap + pos_in_e, e * cap)


def moe_fwd(p, cfg: ModelConfig, x: torch.Tensor, impl: str = "scatter"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss)."""
    if impl not in IMPLS:
        raise ValueError(f"moe_fwd: impl {impl!r} not in {IMPLS}")
    if impl == "a2a":
        env = get_env()
        if env is not None and env.mesh is not None \
                and cfg.n_experts % env.axis_size(env.model) == 0:
            return moe_fwd_a2a(p, cfg, x, env.mesh, env.batch, env.model)
        impl = "scatter"                    # no mesh bound: fall back
    mesh = x.device_mesh if is_dtensor(x) else None
    b, t, d = x.shape
    n = b * t
    xf = replicated(x).reshape(n, d)
    weights, idx, aux = _route({"router": replicated(p["router"])}, cfg, xf)
    e, k = cfg.n_experts, cfg.top_k

    if impl == "dense":
        h = _expert_ffn(p, _on_mesh(xf.expand(e, n, d), mesh))  # (E, N, d)
        onehot = F.one_hot(idx, e).float()                  # (N, k, E)
        comb = (onehot * weights[..., None]).sum(1)         # (N, E)
        out = (replicated(h).float() * comb.mT[..., None]).sum(0)
        return (_on_mesh(out.reshape(b, t, d).to(x.dtype), mesh),
                _on_mesh(aux, mesh))

    cap = capacity(cfg, n)
    buf, dest = _dispatch_local(cfg, xf, weights, idx, cap)
    xe = shard(_on_mesh(buf, mesh), "model", None, None)
    h = replicated(_expert_ffn(p, xe))                      # (E, C, d)
    hflat = torch.cat([h.reshape(e * cap, d), h.new_zeros((1, d))])
    gathered = hflat[dest].reshape(n, k, d).float()
    out = (gathered * weights[..., None]).sum(1)
    return (_on_mesh(out.reshape(b, t, d).to(x.dtype), mesh),
            _on_mesh(aux, mesh))


# ----------------------------------------------------------------------- #
# explicit expert-parallel plan: all-to-all over the model dim             #
# ----------------------------------------------------------------------- #
def _dispatch_local(cfg: ModelConfig, xf: torch.Tensor, weights, idx,
                    cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch (the scatter plan's, and the a2a
    plan's on one shard).  Returns (buf, dest) with buf (E, cap, d)
    ordered globally by expert id."""
    e, k = cfg.n_experts, cfg.top_k
    d = xf.shape[1]
    dest = dispatch(cfg, idx, cap)
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, dest, xf.repeat_interleave(k, dim=0))
    return buf[:e * cap].view(e, cap, d), dest


def moe_fwd_a2a(p, cfg: ModelConfig, x: torch.Tensor, mesh,
                batch_axes: tuple, model_axis: str = "model"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with explicit all-to-all (the reference's
    ``shard_map`` body, ``:133-225``).

    Tokens stay sharded over the batch dims; each rank dispatches its
    local tokens into per-expert buffers, all-to-alls them to the expert
    owners along ``model_axis`` (the mesh dim's subgroup; dim 0 split in
    rank order, as ``lax.all_to_all(split_axis=0, concat_axis=0)``),
    runs its experts' FFN and all-to-alls the results back: two
    all-to-alls of (k N_loc cf d) elements per rank.  Capacity is per
    rank, with no ``min(cap, n)`` (``:193``).  The router and expert
    products are ``torch.matmul``/``torch.einsum``, as the reference's
    body computes them outside its kernels (``:183, 200-203``).

    ``x`` and the weights are DTensors (a dry run: each is redistributed
    to the body's spec, the result comes back as a DTensor) or plain
    tensors that are already this rank's blocks: the batch shard of
    ``x``, the whole router and this rank's ``E / M`` experts."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.models.sharding import P
    e, k = cfg.n_experts, cfg.top_k
    m_sz = mesh_sizes(mesh)[model_axis]
    if e % m_sz:
        raise ValueError(f"moe_fwd_a2a: {e} experts over {m_sz} ranks")
    e_loc = e // m_sz
    bt = batch_axes[0] if len(batch_axes) == 1 else tuple(batch_axes)
    group = mesh.get_group(model_axis)
    ep = P(model_axis, None, None)
    xl = block(x, mesh, P(bt, None, None))
    router = block(p["router"], mesh, P())
    wg, wu, wd = (block(p[w], mesh, ep) for w in ("wg", "wu", "wd"))

    bsz, t, d = xl.shape
    n_loc = bsz * t
    xf = xl.reshape(n_loc, d)
    logits = torch.matmul(xf, router.to(xf.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    weights, idx = top_k(probs, k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    frac = counts(idx[:, 0], e).float() / n_loc
    aux = e * torch.sum(frac * probs.mean(0)) * cfg.router_aux_coef
    for name in mesh.mesh_dim_names:        # pmean over every mesh dim
        aux = funcol.all_reduce(aux, "sum", mesh.get_group(name))
    aux = aux / mesh.size()

    cap = max(8, int(math.ceil(k * n_loc * cfg.capacity_factor / e)))
    buf, dest = _dispatch_local(cfg, xf, weights, idx, cap)
    # ship token blocks to their expert owners
    recv = funcol.wait_tensor(funcol.all_to_all_single(
        buf.reshape(e * cap, d), None, None, group))  # (M, E_loc, C, d)
    xe = recv.reshape(m_sz, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, m_sz * cap, d)
    g = torch.einsum("ecd,edf->ecf", xe, wg.to(xe.dtype))
    u = torch.einsum("ecd,edf->ecf", xe, wu.to(xe.dtype))
    h = torch.einsum("ecf,efd->ecd", F.silu(g) * u, wd.to(xe.dtype))
    # ship results home: the (E_loc, M, C) blocks made rank-major first
    home = h.reshape(e_loc, m_sz, cap, d).transpose(0, 1).contiguous()
    back = funcol.wait_tensor(funcol.all_to_all_single(
        home.reshape(e * cap, d), None, None, group))
    hflat = torch.cat([back.reshape(e * cap, d), back.new_zeros((1, d))])
    gathered = hflat[dest].reshape(n_loc, k, d).float()
    out = (gathered * weights[..., None]).sum(1)
    out = out.reshape(bsz, t, d).to(xl.dtype)
    if not is_dtensor(x):
        return out, aux
    return unblock(out, mesh, P(bt, None, None)), unblock(aux, mesh, P())

