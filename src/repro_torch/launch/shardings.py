"""Parameter/batch/cache sharding rules for the production meshes.

The counterpart of ``repro/launch/shardings.py``, with its rules
unchanged: Megatron-style tensor parallelism on the ``model`` dim
(column-parallel QKV/gate/up projections, row-parallel O/down
projections, a vocab-parallel embedding, expert-parallel MoE weights and
head-sharded SSD state), the batch over ``data`` (and ``pod`` when
present), optimizer moments following their parameters, with
``zero=True`` also slicing the largest free dim of every moment over
``data`` (ZeRO-1).

A spec is a :class:`repro_torch.models.sharding.P`; a sharding is a
:class:`NamedSharding` of a spec over a
:class:`~torch.distributed.device_mesh.DeviceMesh`, whose
:attr:`~NamedSharding.placements` are what ``distribute_tensor`` takes.
A path is the tuple of names from the tree's root
(:func:`repro_torch.tree.paths`).  The port's optimizer keeps its
moments as lists in the parameters' leaf order, so
:func:`opt_shardings` takes the parameters to name them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.sharding import P, mesh_sizes, placements
from repro_torch.tree import map_with_path, paths


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


# ----------------------------------------------------------------------- #
# parameter rules                                                          #
# ----------------------------------------------------------------------- #
_COL = ("wq", "wk", "wv", "wg", "wu", "w1", "in_proj")     # d -> sharded out
_ROW = ("wo", "wd", "w2", "out_proj")                      # sharded in -> d
_VEC_MODEL = ("bq", "bk", "bv", "b1", "a_log", "dt_bias", "d_skip",
              "norm_w", "conv_b")


def param_spec(path: Sequence[str], leaf, cfg: ModelConfig) -> P:
    names = list(path)
    name = names[-1] if names else ""
    nd = leaf.dim()
    in_moe = "moe" in names
    in_conv = name.startswith("conv_w")

    def lead(spec_tail):
        """Pad with None for stacked leading dims (layer groups, experts)."""
        pad = nd - len(spec_tail)
        return P(*([None] * pad + list(spec_tail)))

    if name == "table":                       # (V, d): vocab-parallel
        return P("model", None)
    if name == "unembed":                     # (d, V)
        return P(None, "model")
    if name == "pos_dec":
        return P(None, None)
    if name == "router":                      # replicated: tiny + hot
        return lead([None, None])
    if in_moe and name in ("wg", "wu"):       # (..., E, d, ffe): EP
        return lead(["model", None, None])
    if in_moe and name == "wd":               # (..., E, ffe, d): EP
        return lead(["model", None, None])
    if in_conv:                               # (..., k, conv_dim)
        return lead([None, "model"])
    if name in _COL and nd >= 2:
        return lead([None, "model"])
    if name in _ROW and nd >= 2:
        return lead(["model", None])
    if name in _VEC_MODEL and nd >= 1:
        return lead(["model"])
    return P(*([None] * nd))                  # norms, biases: replicated


def sanitize(spec: P, shape, mesh, *, fallbacks: dict = None) -> P:
    """Drop (or re-home) spec dims the shape cannot divide evenly.

    ``fallbacks`` maps dim index -> alternative dim index: if the spec'd
    axis does not divide dim i but divides dim j, the axis moves there
    (e.g. KV-head sharding falling back to head_dim when Hkv < mesh)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    fallbacks = fallbacks or {}
    sizes = mesh_sizes(mesh)

    def axsize(ax):
        if isinstance(ax, tuple):
            n = 1
            for a in ax:
                n *= sizes[a]
            return n
        return sizes[ax]

    for i in range(len(dims)):
        ax = dims[i]
        if ax is None:
            continue
        if shape[i] % axsize(ax) != 0:
            j = fallbacks.get(i)
            if (j is not None and dims[j] is None
                    and shape[j] % axsize(ax) == 0):
                dims[j] = ax
            dims[i] = None
    return P(*dims)


def param_shardings(params: Any, mesh, cfg: ModelConfig):
    def one(path, leaf):
        spec = sanitize(param_spec(path, leaf, cfg), leaf.shape, mesh)
        return NamedSharding(mesh, spec)

    return map_with_path(one, params)


def opt_shardings(opt_state: Any, mesh, cfg: ModelConfig, *, params: Any,
                  zero: bool = False):
    """Moments follow the params; ZeRO-1 also slices over ``data``.
    ``opt_state`` is the port's ``OptState(step, mu, nu)``; moment ``i``
    of ``mu`` and ``nu`` belongs to leaf ``i`` of ``params``."""
    names = [path for path, _ in paths(params)]

    def one(path, leaf):
        spec = sanitize(param_spec(path, leaf, cfg), leaf.shape, mesh)
        if zero and leaf.dim() >= 2:
            dims = list(spec)
            dims += [None] * (leaf.dim() - len(dims))
            # shard the largest still-unsharded dim over data
            free = [i for i, d in enumerate(dims) if d is None]
            if free:
                big = max(free, key=lambda i: leaf.shape[i])
                if leaf.shape[big] % mesh_sizes(mesh)["data"] == 0:
                    dims[big] = "data"
            spec = P(*dims)
        return NamedSharding(mesh, spec)

    def moments(field, ms):
        return [one((field,) + names[i], m) for i, m in enumerate(ms)]

    # step counter and other scalars: replicated
    return type(opt_state)(step=NamedSharding(mesh, P()),
                           mu=moments("mu", opt_state.mu),
                           nu=moments("nu", opt_state.nu))


# ----------------------------------------------------------------------- #
# batch / cache rules                                                      #
# ----------------------------------------------------------------------- #
def _lead(mesh):
    ba = batch_axes(mesh)
    return ba[0] if len(ba) == 1 else tuple(ba)


def batch_spec(mesh) -> P:
    return P(_lead(mesh))


def batch_shardings(batch_shapes: dict, mesh):
    """tokens/labels: (B, T) -> batch over data(+pod); stub embeddings:
    (B, S, d) likewise: the leading dim is always the global batch.
    ``batch_shapes`` maps names to shapes."""
    lead = _lead(mesh)

    def one(shape):
        spec = sanitize(P(*([lead] + [None] * (len(shape) - 1))), shape,
                        mesh)
        return NamedSharding(mesh, spec)

    return {k: one(tuple(v)) for k, v in batch_shapes.items()}


def cache_spec(mesh, kind: str, ndim: int, *, seq_shard: bool = False) -> P:
    """Decode-state shardings.

    kind "kv": (G, B, Hkv, S, D): batch over data, heads over model;
    ``seq_shard`` (long-context, batch=1) moves data-sharding to S.
    kind "ssm": (G, B, H, S, P) state: heads over model, batch over data.
    kind "conv": (G, B, K-1, C): channels over model.
    """
    b = _lead(mesh)
    if kind == "kv":
        if seq_shard:
            return P(None, None, "model", "data", None)
        return P(None, b, "model", None, None)
    if kind == "ssm":
        return P(None, b, "model", None, None)
    if kind == "conv":
        return P(None, b, None, "model")
    raise ValueError(kind)
