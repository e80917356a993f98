"""Logical-axis sharding environment for the model stack.

The counterpart of ``repro/models/sharding.py``: model code annotates
activations with *logical* dims ("batch", "model", "seq"); the launcher
binds them to the dims of a :class:`torch.distributed.device_mesh.
DeviceMesh` (one pod: ``data``/``model``; two pods: the batch spans
``("pod", "data")``).  Outside any environment (every serving and
training run on one card, the CPU tests) :func:`shard` is the identity,
so the same model code runs unsharded on one device and sharded over a
mesh.

Where the reference calls ``with_sharding_constraint``, which acts only
under ``jit`` on a mesh, :func:`shard` redistributes a
:class:`~torch.distributed.tensor.DTensor` to the sanitized spec, the
collective that GSPMD would insert there.  A plain tensor passes
unchanged: it is either a whole tensor on one device or one rank's local
shard, and neither has a layout to constrain.

:class:`P` stands in for ``jax.sharding.PartitionSpec``: a tuple with one
entry per tensor dim, each ``None``, a mesh dim name, or a tuple of mesh
dim names that split that tensor dim major to minor.  :func:`placements`
turns it into DTensor placements over a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch


class P(tuple):
    """A partition spec: ``P("data", None)``; equal to the plain tuple
    of its entries, as ``jax.sharding.PartitionSpec`` is."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a DeviceMesh (``Mesh.shape`` in JAX)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``: a spec entry naming
    mesh dim ``m`` at tensor dim ``i`` is ``Shard(i)`` at ``m``; a tuple
    entry shards tensor dim ``i`` on each of its mesh dims, which must
    come in the mesh's order (JAX splits major to minor, DTensor splits
    mesh dim by mesh dim); every other mesh dim replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"order {tuple(names)}")
        for m in idx:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"mesh dim {names[m]!r} appears twice in "
                                 f"{tuple(spec)!r}")
            out[m] = Shard(i)
    return out


@dataclasses.dataclass(frozen=True)
class AxisEnv:
    batch: Tuple[str, ...] = ("data",)
    model: str = "model"
    seq: Optional[str] = None       # sequence-parallel axis, if any
    sizes: Tuple[Tuple[str, int], ...] = ()   # mesh axis sizes
    # concrete mesh for the explicit sub-blocks (the a2a expert plan);
    # compare=False keeps the dataclass hashable/comparable by config
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    def axis_size(self, name) -> int:
        d = dict(self.sizes)
        if isinstance(name, tuple):
            n = 1
            for a in name:
                n *= d.get(a, 1)
            return n
        return d.get(name, 1)


_ENV: Optional[AxisEnv] = None


def set_env(env: Optional[AxisEnv]) -> None:
    global _ENV
    _ENV = env


def get_env() -> Optional[AxisEnv]:
    return _ENV


@contextlib.contextmanager
def axis_env(env: AxisEnv):
    prev = _ENV
    set_env(env)
    try:
        yield env
    finally:
        set_env(prev)


def logical(*dims: Optional[str]) -> P:
    """Translate logical dims to a spec under the active env."""
    env = _ENV or AxisEnv()
    out = []
    for d in dims:
        if d is None:
            out.append(None)
        elif d == "batch":
            out.append(env.batch if len(env.batch) > 1 else env.batch[0])
        elif d == "model":
            out.append(env.model)
        elif d == "seq":
            out.append(env.seq)
        else:  # already-physical axis name
            out.append(d)
    return P(*out)


def _spec_for(x: torch.Tensor, dims) -> P:
    """The spec :func:`shard` constrains ``x`` to: dims not divisible
    by their mesh axis are left unconstrained."""
    spec = list(logical(*dims))
    spec += [None] * (x.dim() - len(spec))
    for i, ax in enumerate(spec):
        if ax is not None and x.shape[i] % _ENV.axis_size(ax) != 0:
            spec[i] = None
    return P(*spec)


def shard(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """The sharding constraint under the env; identity when unbound, and
    for a plain tensor.  A DTensor is redistributed to the spec."""
    if _ENV is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          placements(_spec_for(x, dims), x.device_mesh))


def replicated(x):
    """``x`` whole on every rank, for an op that has no sharding rule in
    DTensor: a DTensor is gathered (the collective GSPMD would insert
    before that op) and its local tensor returned; anything else is
    returned as it is.  What comes out is a plain tensor, so the op and
    what follows it run on each rank's full copy.  Its gradient is taken
    as replicated: right where every rank computes the same whole result
    from it and gets the whole cotangent (the MoE scatter plan), wrong
    where it meets rank-local data (use :func:`block` or
    :func:`per_shard`'s ``whole`` there)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    full = [Replicate()] * x.device_mesh.ndim
    return x.redistribute(x.device_mesh, full).to_local()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing the distributed
    package where no DTensor can exist yet (every run on one card)."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def per_shard(fn, *xs: torch.Tensor, shardable: Sequence[int] = (0, 1),
              **whole: torch.Tensor):
    """``fn(*xs, **whole)`` on each rank's local shards, for a function
    that is independent along the leading dims ``shardable`` of ``xs``
    (attention: batch and heads): per mesh dim, the inputs keep a
    ``Shard(i)`` they all share for some ``i`` in ``shardable`` and are
    gathered on any other (the collective GSPMD would insert); the result
    carries the first input's placements (each output's, where ``fn``
    returns a tuple).  ``whole`` (the SSD's ``a`` and ``d_skip``) go to
    every rank whole; each rank's gradient of one is a partial sum over
    the mesh dims whose ranks split ``xs``, as shard_map's transpose sums
    an unmapped input's cotangent.  Plain tensors go to ``fn`` as they
    are."""
    if not is_dtensor(xs[0]):
        return fn(*xs, **whole)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = xs[0].device_mesh
    keep = []
    for m in range(mesh.ndim):
        ps = {x.placements[m] for x in xs}
        p = ps.pop() if len(ps) == 1 else None
        ok = (isinstance(p, Shard) and p.dim in shardable
              and all(x.shape[p.dim] % mesh.size(m) == 0 for x in xs))
        keep.append(p if ok else Replicate())
    local = [x.redistribute(mesh, keep).to_local() for x in xs]
    split = [Partial() if isinstance(p, Shard) else Replicate() for p in keep]
    kw = {k: (v.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=split) if is_dtensor(v) else v)
        for k, v in whole.items()}
    out = fn(*local, **kw)
    wrap = [DTensor.from_local(y, mesh, keep, run_check=False)
            for y in (out if isinstance(out, tuple) else (out,))]
    return tuple(wrap) if isinstance(out, tuple) else wrap[0]


class _ScaleCotangent(torch.autograd.Function):
    """The identity forward; the backward divides the cotangent by ``n``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def block(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``, as ``shard_map`` hands
    an input to its body (``in_specs``): a DTensor is redistributed to
    the spec and its local tensor taken; a plain tensor is already this
    rank's block.  The local tensor's gradient is a partial sum over
    every mesh dim that ``spec`` leaves unsharded, where shard_map's
    transpose sums an unmapped input's cotangent: each rank of such a dim
    holds the whole input but meets its own data.  Its body's results
    come back through :func:`unblock`."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    want = placements(spec, mesh)
    return x.redistribute(mesh, want).to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) else p for p in want])


def unblock(y: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block ``y`` as a DTensor placed by ``spec``, as
    ``shard_map`` returns a result (``out_specs``).  Every rank of a mesh
    dim that ``spec`` leaves unsharded holds the same value, and each
    such copy takes its share of the cotangent: the cotangent is divided
    by the number of copies, as shard_map's transpose divides it, so that
    the partial sums of :func:`block` count each copy once.  The forward
    is ``y`` itself."""
    from torch.distributed.tensor import DTensor
    sizes = mesh_sizes(mesh)
    named = {a for entry in spec if entry is not None
             for a in (entry if isinstance(entry, tuple) else (entry,))}
    copies = math.prod(n for a, n in sizes.items() if a not in named)
    if copies > 1 and y.requires_grad:
        y = _ScaleCotangent.apply(y, copies)
    return DTensor.from_local(y, mesh, placements(spec, mesh),
                              run_check=False)


def split_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (..., n * k) as (..., n, k): the heads of a projection.  A
    DTensor sharded along its last dim keeps that dim's shards on the new
    ``n`` dim where its mesh dims divide ``n`` (each rank's block of
    whole heads, split locally: DTensor does not split a sharded dim on
    every release); on mesh dims that do not divide it, it is gathered
    first, as GSPMD would reshard there."""
    if not is_dtensor(x):
        return x.reshape(x.shape[:-1] + (n, -1))
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, last = x.device_mesh, x.dim() - 1
    along = [m for m, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim % x.dim() == last]
    if n % math.prod(mesh.size(m) for m in along):
        keep = [Replicate() if m in along else p
                for m, p in enumerate(x.placements)]
        x = x.redistribute(mesh, keep)
    local = x.to_local()
    out = local.reshape(local.shape[:-1] + (local.shape[-1] * n
                                            // x.shape[-1], -1))
    shape = x.shape[:-1] + (n, x.shape[-1] // n)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=shape, stride=tuple(stride))


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., n, k) as (..., n * k), the inverse of
    :func:`split_last`: a DTensor's shards of the ``n`` dim become the
    merged dim's, merged locally (so autograd's split of the gradient is
    local too)."""
    if not is_dtensor(x):
        return x.reshape(x.shape[:-2] + (-1,))
    from torch.distributed.tensor import DTensor
    if any(getattr(p, "dim", None) is not None
           and p.dim % x.dim() == x.dim() - 1 for p in x.placements):
        raise ValueError("merge_last: the last dim is sharded")
    last = x.dim() - 2
    placements = [type(p)(last) if getattr(p, "dim", None) is not None
                  and p.dim % x.dim() == last else p for p in x.placements]
    local = x.to_local()
    out = local.reshape(local.shape[:-2] + (-1,))
    shape = x.shape[:-2] + (x.shape[-2] * x.shape[-1],)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(out, x.device_mesh, placements,
                              run_check=False, shape=shape,
                              stride=tuple(stride))


def _flattenable(x: torch.Tensor, nfold: int) -> torch.Tensor:
    """``x`` with every mesh dim that shards one of its ``nfold`` leading
    dims inside their flatten (a dim past the first, with more than one
    element before it) moved to the last dim where that dim divides, and
    gathered where it does not: the redistribution GSPMD would insert
    before such a reshape."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, last = x.device_mesh, x.dim() - 1
    inner = [m for m, p in enumerate(x.placements)
             if isinstance(p, Shard) and 1 <= p.dim < nfold
             and math.prod(x.shape[:p.dim]) > 1]
    if not inner:
        return x
    out = list(x.placements)
    split = math.prod(mesh.size(m) for m, p in enumerate(out)
                      if isinstance(p, Shard) and p.dim == last)
    for m in inner:
        if x.shape[last] % (split * mesh.size(m)) == 0:
            split *= mesh.size(m)
            out[m] = Shard(last)
        else:
            out[m] = Replicate()
    return x.redistribute(mesh, out)


def rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., k) as the rows of a matrix (-1, k), as a product with
    one matrix reads it.  A DTensor sharded on an inner leading dim (the
    positions, where a batch shard holds fewer rows than a mesh dim has
    ranks) is first redistributed (:func:`_flattenable`): flattened as it
    is, it would carry a strided shard, whose propagation in a product
    reads the data (torch 2.13; fake tensors have none), or be refused
    (torch 2.11)."""
    if is_dtensor(x):
        x = _flattenable(x, x.dim() - 1)
    return x.reshape(-1, x.shape[-1])


class _Unrows(torch.autograd.Function):
    """The reshape of :func:`unrows`, whose backward flattens the
    gradient as :func:`rows` flattens an operand."""

    @staticmethod
    def forward(ctx, y, shape):
        ctx.shape = y.shape
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        return rows(grad).reshape(ctx.shape), None


def unrows(y: torch.Tensor, lead) -> torch.Tensor:
    """The rows ``y`` (m, n) of a product as ``lead + (n,)``, the inverse
    of :func:`rows`; a DTensor's gradient comes back through
    :func:`rows` too."""
    shape = tuple(lead) + y.shape[-1:]
    if not is_dtensor(y):
        return y.reshape(shape)
    return _Unrows.apply(y, shape)


@functools.cache
def _index_copy_rule() -> None:
    """DTensor's sharding rule for ``index_copy_`` (torch 2.11 has none):
    each rank writes its block, the destination and the source placed
    alike on every dim but the written one, the index whole.  Once per
    process."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.index_copy_.default)
    def _rule(x, dim, index, src):
        d = dim % x.ndim
        r = Replicate()
        return [([r], [r, None, r, r])] + [
            ([Shard(i)], [Shard(i), None, r, Shard(i)])
            for i in range(x.ndim) if i != d]


def index_copy_(x: torch.Tensor, dim: int, index: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``x.index_copy_(dim, index, src)``: the decode cache's write at a
    tensor position.  A DTensor cache is written on each rank's block
    (:func:`_index_copy_rule`), its written dim unsharded."""
    if is_dtensor(x):
        _index_copy_rule()
    return x.index_copy_(dim, index, src)


def _contiguous_stride(shape) -> tuple:
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


class _VocabParallelLookup(torch.autograd.Function):
    """Rows of a table sharded along its vocab over some mesh dims, for
    tokens sharded along the batch over others (Megatron's vocab-parallel
    embedding), on each rank's blocks: a rank looks up the tokens its
    rows hold and gives zeros for the rest, so the output is a partial sum
    over the vocab's mesh dims; the backward adds each row's gradient into
    the rank's own block, a partial sum over the batch's mesh dims."""

    @staticmethod
    def forward(ctx, tokens, table):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        mesh = table.device_mesh
        tok_pl = (list(tokens.placements) if is_dtensor(tokens)
                  else [Replicate()] * mesh.ndim)
        vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
        if any(v and not isinstance(t, Replicate)
               for v, t in zip(vocab, tok_pl)):
            raise ValueError("vocab-parallel lookup: tokens and table are "
                             "sharded over one mesh dim")
        tok = tokens.to_local() if is_dtensor(tokens) else tokens
        tab = table.to_local()
        rows, first = table.shape[0], 0     # this rank's block of rows
        for m, v in enumerate(vocab):
            if v:
                rows //= mesh.size(m)
                first += mesh.get_local_rank(m) * rows
        mine = (tok >= first) & (tok < first + rows)
        idx = torch.where(mine, tok - first, torch.zeros_like(tok))
        out = torch.nn.functional.embedding(idx, tab) * mine[..., None]
        ctx.save_for_backward(idx, mine)
        ctx.meta = (mesh, tok_pl, vocab, list(table.placements), tab.shape,
                    table.shape)
        gshape = tuple(tokens.shape) + (table.shape[1],)
        return DTensor.from_local(
            out, mesh, [Partial() if v else t for v, t in zip(vocab, tok_pl)],
            run_check=False, shape=gshape, stride=_contiguous_stride(gshape))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        idx, mine = ctx.saved_tensors
        mesh, tok_pl, vocab, tab_pl, local_shape, table_shape = ctx.meta
        want = [Replicate() if v else t for v, t in zip(vocab, tok_pl)]
        g = grad.redistribute(mesh, want).to_local() * mine[..., None]
        gtab = torch.zeros(local_shape, dtype=g.dtype, device=g.device)
        gtab.index_add_(0, idx.reshape(-1), g.reshape(-1, g.shape[-1]))
        placed = [p if v else (Partial() if not isinstance(t, Replicate)
                               else Replicate())
                  for v, p, t in zip(vocab, tab_pl, tok_pl)]
        return None, DTensor.from_local(
            gtab, mesh, placed, run_check=False, shape=table_shape,
            stride=_contiguous_stride(table_shape))


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table goes through the
    vocab-parallel lookup (:class:`_VocabParallelLookup`), whose output
    is a partial sum for the caller's constraint to reduce: DTensor's own
    rules for the gather disagree between torch releases in its backward
    (an unnormalized shard dim on 2.11, a partial type that a tied head's
    gradient cannot add to on 2.13)."""
    if not is_dtensor(table):
        return table[tokens]
    return _VocabParallelLookup.apply(tokens, table)
