"""(architecture x input-shape) cell definitions for the dry run.

The counterpart of ``repro/launch/specs.py``.  ``build_cell`` assembles
everything a dry run needs:

* the step function (train_step / prefill_step / serve_step, the calls
  of the reference's ``:155-211``);
* its arguments: parameters, optimizer and compression state, batch and
  cache as DTensors over the mesh, each placed by
  :mod:`repro_torch.launch.shardings`, over *fake* local tensors.

The reference builds ``ShapeDtypeStruct`` stand-ins that XLA compiles
against; here the stand-ins are ``FakeTensorMode`` tensors that the step
runs on, so nothing is allocated: :func:`param_structs` refuses to run
outside a fake mode (jamba-1.5-large's ~796 GB of parameters must never
be allocated).  The fake tensors are CPU tensors, so every kernel wrapper
takes its plain version, as the reference's dry run runs on the CPU
backend where ``use_pallas()`` is false.

Shape suite: train_4k, prefill_32k, decode_32k, long_500k.
``long_500k`` raises ``CellSkipped`` for quadratic-attention
architectures.  ``build_cell`` also takes a :class:`ShapeCell` of its own
(a step's real batch and length, to count it).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.registry import Model
from repro_torch.models.sharding import AxisEnv, P, mesh_sizes, shard
from repro_torch.optim import AdamW, init_compression
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.tree import leaves, map_with_path, unflatten


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str           # train | prefill | decode
    seq: int
    global_batch: int
    seq_shard: bool = False


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1,
                           seq_shard=True),
}


class CellSkipped(Exception):
    """Raised for (arch x shape) cells the suite excludes."""


def check_cell(cfg: ModelConfig, shape: ShapeCell) -> None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        raise CellSkipped(
            f"{cfg.name}: full attention is quadratic at 524288 ctx; "
            "long_500k runs only for SSM/hybrid")


def axis_env_for(mesh) -> AxisEnv:
    return AxisEnv(batch=batch_axes(mesh), model="model",
                   sizes=tuple(mesh_sizes(mesh).items()), mesh=mesh)


@functools.cache
def _register_rules() -> None:
    """DTensor's sharding rule for the gemm operator that training's
    products go through (``kernels/gemm.py`` ``gemm_grad``): the rules
    of a (batched) matrix product, so that the operator runs on each
    rank's blocks of its operands.  Once per process."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.gemm.default)
    def _gemm_rule(a, b, block):
        r, s = Replicate(), Shard
        lead = a.ndim - 2                   # 1 for the batched product
        out = [([r], [r, r, None]),
               ([s(lead)], [s(lead), r, None]),
               ([s(lead + 1)], [r, s(lead + 1), None]),
               ([Partial()], [s(lead + 1), s(lead), None])]
        if lead:
            out.append(([s(0)], [s(0), s(0), None]))
        return out


# ----------------------------------------------------------------------- #
# fake-tensor stand-ins                                                    #
# ----------------------------------------------------------------------- #
def _need_fake() -> None:
    from torch._guards import active_fake_mode
    if active_fake_mode() is None:
        raise RuntimeError("build the dry run's stand-ins under "
                           "torch._subclasses.FakeTensorMode: they are "
                           "never allocated")


def _dist(x: torch.Tensor, sharding: shd.NamedSharding) -> torch.Tensor:
    """``x`` (a fake global tensor) as a DTensor with this rank's block.
    The spec must divide every dim it shards (``sanitize`` sees to it):
    no uneven shard reaches DTensor."""
    from torch.distributed.tensor import distribute_tensor
    sizes = mesh_sizes(sharding.mesh)
    for i, entry in enumerate(sharding.spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= sizes[a] if a is not None else 1
        if x.shape[i] % n:
            raise ValueError(f"spec {tuple(sharding.spec)} shards dim {i} "
                             f"of {tuple(x.shape)} unevenly")
    out = distribute_tensor(x.detach(), sharding.mesh, sharding.placements,
                            src_data_rank=None)
    return out.requires_grad_(x.requires_grad)


def _lead(mesh):
    ba = batch_axes(mesh)
    return ba[0] if len(ba) == 1 else tuple(ba)


def _batch(shape, dtype, mesh) -> torch.Tensor:
    """A batch-leading input, the batch over data (and pod)."""
    spec = shd.sanitize(P(*([_lead(mesh)] + [None] * (len(shape) - 1))),
                        shape, mesh)
    x = (torch.zeros(shape, dtype=dtype) if dtype.is_floating_point
         else torch.randint(0, 2, shape, dtype=dtype))
    return _dist(x, shd.NamedSharding(mesh, spec))


def _extra_specs(model: Model, b: int, mesh) -> Dict[str, Any]:
    dt = torch_dtype(model.cfg.dtype)
    return {k: _batch(s, dt, mesh)
            for k, s in model.extra_inputs(b, 0).items()}


def _cache_specs(model: Model, b: int, max_len: int, mesh,
                 *, seq_shard: bool) -> Any:
    cache = model.init_cache(b, max_len, torch.bfloat16, device="cpu")

    def classify(path, leaf):
        if leaf.dim() == 5:
            kind = "kv" if leaf.shape[3] == max_len else "ssm"
            spec = shd.cache_spec(mesh, kind, 5,
                                  seq_shard=seq_shard and kind == "kv")
            # KV-head sharding falls back to head_dim when Hkv < axis
            spec = shd.sanitize(spec, leaf.shape, mesh, fallbacks={2: 4})
        elif leaf.dim() == 4:
            spec = shd.sanitize(shd.cache_spec(mesh, "conv", 4),
                                leaf.shape, mesh)
        else:
            spec = P()
        return _dist(leaf, shd.NamedSharding(mesh, spec))

    return map_with_path(classify, cache)


def param_structs(model: Model, mesh, *, master: bool = True) -> Any:
    """The model's parameters as DTensors over fake tensors, placed by
    ``param_shardings``: float32 masters that take a gradient (training,
    the reference's storage) or, with ``master=False``, the serving
    storage of ``models/layers.py``."""
    _need_fake()
    params = model.init(torch.Generator().manual_seed(0), "cpu",
                        master=master)
    shards = leaves(shd.param_shardings(params, mesh, model.cfg))
    return unflatten(params, [_dist(p, s)
                              for p, s in zip(leaves(params), shards)])


# ----------------------------------------------------------------------- #
# cells                                                                    #
# ----------------------------------------------------------------------- #
@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeCell
    fn: Callable
    args: tuple                 # DTensors over fake tensors


def _implicit(fn: Callable) -> Callable:
    """``fn`` with plain tensors made inside it (positions, masks) taken
    as replicated beside the DTensors."""
    def run(*args):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args)
    return run


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next token of each row.  The vocab-sharded logits of the last
    position are gathered first: DTensor's argmax over a sharded dim
    reads data-dependent offsets, which fake tensors do not have."""
    return torch.argmax(shard(logits[:, -1, :], "batch", None), -1).int()


def build_cell(model: Model, arch: str, shape_name: Union[str, ShapeCell],
               mesh, *, remat: str = "dots", n_micro: int = 1,
               zero: bool = False, grad_compress: bool = False,
               moe_impl: str = "scatter", unroll: bool = False,
               extra_seq_shard: Optional[bool] = None) -> Cell:
    """Must run under ``FakeTensorMode``, as must the cell's ``fn``.
    ``unroll`` is accepted and ignored: the layer stack is a Python
    loop, so every count is already at full depth."""
    _register_rules()
    cfg = model.cfg
    shape = (shape_name if isinstance(shape_name, ShapeCell)
             else SHAPES[shape_name])
    check_cell(cfg, shape)
    b, t = shape.global_batch, shape.seq
    text_t = model.text_len(t) if shape.kind == "train" else t
    seq_shard = (shape.seq_shard if extra_seq_shard is None
                 else extra_seq_shard)

    if shape.kind == "train":
        pstructs = param_structs(model, mesh)
        opt = AdamW()
        tcfg = TrainConfig(n_micro=n_micro, remat=remat,
                           grad_compress=grad_compress, moe_impl=moe_impl,
                           unroll_layers=unroll)
        step = make_train_step(model, tcfg, opt, total_steps=10000)
        ostate = opt.init(pstructs)
        oshard = shd.opt_shardings(ostate, mesh, cfg, params=pstructs,
                                   zero=zero)
        ostructs = type(ostate)(
            step=ostate.step,
            mu=[_dist(m, s) for m, s in zip(ostate.mu, oshard.mu)],
            nu=[_dist(m, s) for m, s in zip(ostate.nu, oshard.nu)])
        pshard = leaves(shd.param_shardings(pstructs, mesh, cfg))
        cstate = init_compression(pstructs)
        cstructs = type(cstate)([_dist(r, s) for r, s in
                                 zip(cstate.residual, pshard)])
        batch = {"tokens": _batch((b, text_t), torch.int32, mesh),
                 "labels": _batch((b, text_t), torch.int32, mesh)}
        batch.update(_extra_specs(model, b, mesh))
        return Cell(arch, shape, _implicit(step),
                    (pstructs, ostructs, cstructs, batch, 0))

    pstructs = param_structs(model, mesh, master=False)
    cache = _cache_specs(model, b, t, mesh, seq_shard=seq_shard)

    if shape.kind == "prefill":
        text = model.text_len(t)
        extra = _extra_specs(model, b, mesh)

        @torch.no_grad()
        def prefill_step(params, tokens, cache, extra_in):
            logits, _, cache = model.forward(
                params, tokens, cache=cache, cache_pos=0, moe_impl=moe_impl,
                last_only=True, **extra_in)
            return _greedy(logits), cache

        args = (pstructs, _batch((b, text), torch.int32, mesh), cache, extra)
        return Cell(arch, shape, _implicit(prefill_step), args)

    # decode: one new token against a full-length cache (its last slot)
    @torch.no_grad()
    def serve_step(params, tok, cache, pos):
        logits, _, cache = model.forward(
            params, tok, cache=cache, cache_pos=pos, moe_impl=moe_impl)
        return _greedy(logits), cache

    args = (pstructs, _batch((b, 1), torch.int32, mesh), cache, t - 1)
    return Cell(arch, shape, _implicit(serve_step), args)
