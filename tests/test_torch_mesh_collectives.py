"""The port's mesh paths on real collectives, against the JAX reference's.

Three gloo jobs (``torch.multiprocessing`` spawn, a ``FileStore`` in the
test's temporary directory) and one JAX process on 8 fake XLA CPU
devices share one set of seeded numpy inputs:

1. 8 ranks as ``(data=2, model=4)``: ``moe_fwd(impl="a2a")`` of reduced
   granite-moe (``moe_fwd_a2a``: two all-to-alls over the model dim's
   subgroup) at ``capacity_factor=8.0`` (no drops) and at the default
   (drops); and a checkpoint of reduced qwen1.5-4b's parameters saved
   from DTensors over ``(data=4, model=2)``;
2. the reference (a subprocess, as ``tests/test_models.py:135-176`` runs
   it): the same two a2a calls from the same weights, ``compressed_psum``
   under ``shard_map`` on 4 devices, a restore of the port's checkpoint
   onto a 4-device mesh, and a checkpoint of its own;
3. 4 ranks: ``compressed_psum`` over the group, and both checkpoints
   restored with ``shardings=`` onto ``(data=2, model=2)`` (an elastic
   restart is a new job).

The gradients of weights that several ranks hold (the a2a plan's router
and experts, the SSD's ``a`` and ``d_skip``) are partial sums that the
port adds over those ranks, as ``shard_map``'s transpose does: job 1
takes the a2a plan's gradients at ``(data=2, model=4)`` beside the
reference's ``jax.grad`` (job 2), where each rank holds one expert (the
reference pairs tokens with the wrong experts where a rank holds two);
job 3 takes them at ``(data=2, model=2)`` against the dense oracle, with
the pre-fix control and one ``make_train_step`` step of reduced
granite-moe; a fourth job of 2 ranks, beside the reference, takes the
SSD's at ``(data=2, model=1)``.

The BLAS-offload mesh (``make_offload_mesh``) runs in this process over
a one-rank gloo group, as ``tests/test_multidevice.py:431`` asserts it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEED = 0
B, T = 4, 8
RANKS_PSUM = 4
STEP = 10                   # the train step's count: lr 0.5 x peak


def _inputs(path: str) -> None:
    from repro_torch.models.registry import get_config
    cfg = get_config("granite_moe_1b_a400m").reduced()
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    rng = np.random.default_rng(SEED)

    def w(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    scales = np.array([1.0, 3.0, 0.01, 40.0], np.float32)[:, None, None]

    def small(*shape):          # the model's own init scale
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    # the gradient cases' inputs are drawn after the others, which keep
    # their values
    np.savez(path, router=w(d, e), wg=w(e, d, ff), wu=w(e, d, ff),
             wd=w(e, ff, d), x=rng.standard_normal((B, T, d)).astype(
                 np.float32),
             g=(rng.standard_normal((RANKS_PSUM, 64, 33)) * scales).astype(
                 np.float32),
             table=rng.standard_normal((16, 6)).astype(np.float32),
             tok=rng.integers(0, 16, (8, 5)),
             tw=rng.standard_normal((8, 5, 6)).astype(np.float32),
             g_router=small(d, e), g_wg=small(e, d, ff),
             g_wu=small(e, d, ff), g_wd=small(e, ff, d),
             tokens=rng.integers(0, cfg.vocab, (B, 2 * T)),
             labels=rng.integers(0, cfg.vocab, (B, 2 * T)),
             ssd_x=small(B, 4 * T, d),
             ssd_w=rng.standard_normal((B, 4 * T, d)).astype(np.float32))


# --------------------------------------------------------------------- #
# the gloo jobs                                                          #
# --------------------------------------------------------------------- #
WEIGHTS = ("router", "wg", "wu", "wd")
EXPERT_SPEC = ("model", None, None)


def _moe_grads(inp, cfg, mesh, out: dict, tag: str) -> None:
    """The a2a plan's gradients of ``sum(y**2) + aux`` on DTensors over
    ``mesh``, whole on every rank: ``grad_{tag}_{name}``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import moe
    from repro_torch.models.sharding import (AxisEnv, P, axis_env,
                                             mesh_sizes, placements)
    env = AxisEnv(batch=("data",), model="model",
                  sizes=tuple(mesh_sizes(mesh).items()), mesh=mesh)
    p = {k: distribute_tensor(torch.from_numpy(inp[f"g_{k}"]), mesh,
                              placements(P() if k == "router"
                                         else P(*EXPERT_SPEC), mesh),
                              src_data_rank=None).requires_grad_()
         for k in WEIGHTS}
    x = distribute_tensor(torch.from_numpy(inp["x"]), mesh, placements(
        P("data", None, None), mesh), src_data_rank=None).requires_grad_()
    with axis_env(env):
        y, aux = moe.moe_fwd(p, cfg, x, impl="a2a")
    ((y ** 2).sum() + aux).backward()
    for k in WEIGHTS:
        out[f"grad_{tag}_{k}"] = p[k].grad.full_tensor().numpy()
    out[f"grad_{tag}_x"] = x.grad.full_tensor().numpy()


def _oracle_grads(inp, cfg, n_data: int, out: dict, tag: str) -> None:
    """The dense oracle of the a2a plan's loss on plain tensors: every
    expert on every token for ``y``, and the aux loss as the plan takes
    it, the mean over the ``n_data`` batch shards of each shard's
    (its body computes the aux of its own tokens, then ``pmean``)."""
    from repro_torch.models import moe
    p = {k: torch.from_numpy(inp[f"g_{k}"]).requires_grad_()
         for k in WEIGHTS}
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y, _ = moe.moe_fwd(p, cfg, x, impl="dense")
    aux = sum(moe.moe_fwd(p, cfg, xs, impl="dense")[1]
              for xs in x.chunk(n_data)) / n_data
    ((y ** 2).sum() + aux).backward()
    for k in WEIGHTS:
        out[f"oracle_{tag}_{k}"] = p[k].grad.numpy()
    out[f"oracle_{tag}_x"] = x.grad.numpy()


def _prefix_control(mesh) -> tuple:
    """``moe.block`` and ``moe.unblock`` as they were before the sharded
    gradients were summed: ``to_local()`` with its default gradient
    placements, ``from_local`` without the cotangent's division."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import is_dtensor, placements

    def block(x, mesh_, spec):
        if not is_dtensor(x):
            return x
        return x.redistribute(mesh_, placements(spec, mesh_)).to_local()

    def unblock(y, mesh_, spec):
        return DTensor.from_local(y, mesh_, placements(spec, mesh_),
                                  run_check=False)

    return block, unblock


def _train_step(inp, mesh, out: dict) -> None:
    """One ``make_train_step`` step of reduced granite-moe with the a2a
    plan on DTensors over ``mesh`` (parameters and moments placed by
    ``param_shardings``, the batch over data), and the same step forced
    plain on this process (the scatter plan, plain tensors), each from
    the same seeded weights.  No token is dropped in either plan
    (``capacity_factor=8``), and the router's aux loss is off: the a2a
    plan's is the mean of its shards' (``_oracle_grads``), the scatter
    plan's the whole batch's, another function."""
    import dataclasses

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import shardings as shd
    from repro_torch.launch import specs
    from repro_torch.models.registry import Model, get_config
    from repro_torch.models.sharding import P, axis_env, placements
    from repro_torch.optim import AdamW, init_compression
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.tree import leaves, unflatten
    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m").reduced(),
                              capacity_factor=8.0, router_aux_coef=0.0)
    model = Model.from_config(cfg)
    batch = {k: torch.from_numpy(inp[k].astype(np.int32))
             for k in ("tokens", "labels")}
    for tag in ("a2a", "plain"):
        params = model.init(torch.Generator().manual_seed(SEED), "cpu",
                            master=True)
        opt = AdamW()
        step = make_train_step(model, TrainConfig(
            moe_impl="a2a" if tag == "a2a" else "scatter"), opt,
            total_steps=100)
        if tag == "plain":
            res = step(params, opt.init(params), init_compression(params),
                       batch, STEP)
        else:
            sh = leaves(shd.param_shardings(params, mesh, cfg))

            def place(t, s):
                return distribute_tensor(t.detach(), mesh, s.placements,
                                         src_data_rank=None)

            params = unflatten(params, [place(t, s).requires_grad_()
                                        for t, s in zip(leaves(params), sh)])
            state = opt.init(params)
            state = type(state)(
                step=state.step,
                mu=[place(torch.zeros(t.shape), s)
                    for t, s in zip(leaves(params), sh)],
                nu=[place(torch.zeros(t.shape), s)
                    for t, s in zip(leaves(params), sh)])
            dbatch = {k: distribute_tensor(v, mesh, placements(
                P("data", None), mesh), src_data_rank=None)
                for k, v in batch.items()}
            with axis_env(specs.axis_env_for(mesh)):
                res = specs._implicit(step)(params, state,
                                            init_compression(params),
                                            dbatch, STEP)
        whole = [t.full_tensor() if hasattr(t, "full_tensor") else t
                 for t in leaves(res[0])]
        for i, t in enumerate(whole):
            out[f"step_{tag}_{i}"] = t.detach().numpy()
        for k, v in res[3].items():
            v = v.full_tensor() if hasattr(v, "full_tensor") else v
            out[f"metric_{tag}_{k}"] = v.detach().numpy()


def _ssd_grads(inp, mesh, out: dict) -> None:
    """``ssd_fwd`` of reduced mamba2's first layer on DTensors over
    ``mesh`` (parameters placed by ``param_spec``, the input over data)
    and on plain tensors: the gradients of a weighted sum, whole.  The
    input is at the embedding's scale (0.02): at unit scale some head's
    decay over a chunk passes float32's range in the masked half of the
    intra-chunk exponent, whose gradient is then 0 x inf, in the
    reference's formulation as in the port's."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import shardings as shd
    from repro_torch.launch import specs
    from repro_torch.models import ssm
    from repro_torch.models.registry import get_config
    from repro_torch.models.sharding import P, axis_env, placements
    cfg = get_config("mamba2_1_3b").reduced()
    plain = ssm.init_ssm(torch.Generator().manual_seed(SEED), cfg, "cpu")
    x, w = (torch.from_numpy(inp[k]) for k in ("ssd_x", "ssd_w"))
    on = {k: distribute_tensor(v, mesh, shd.NamedSharding(
        mesh, shd.sanitize(shd.param_spec(("blocks", "0", "ssm", k), v,
                                          cfg), v.shape, mesh)).placements,
        src_data_rank=None).requires_grad_() for k, v in plain.items()}
    batch = placements(P("data", None, None), mesh)
    xd = distribute_tensor(x, mesh, batch, src_data_rank=None)
    wd = distribute_tensor(w, mesh, batch, src_data_rank=None)
    with axis_env(specs.axis_env_for(mesh)):
        (ssm.ssd_fwd(on, cfg, xd.requires_grad_(), chunk=16) * wd) \
            .sum().backward()
    p = {k: v.clone().requires_grad_() for k, v in plain.items()}
    xp = x.clone().requires_grad_()
    (ssm.ssd_fwd(p, cfg, xp, chunk=16) * w).sum().backward()
    for k in plain:
        out[f"ssd_{k}"] = on[k].grad.full_tensor().numpy()
        out[f"ssd_plain_{k}"] = p[k].grad.numpy()
    out["ssd_x"] = xd.grad.full_tensor().numpy()
    out["ssd_plain_x"] = xp.grad.numpy()


def _job(rank: int, world: int, task: str, tmp: str) -> None:
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe
    from repro_torch.models.registry import Model, get_config
    from repro_torch.models.sharding import (AxisEnv, P, axis_env,
                                             mesh_sizes, placements)
    from repro_torch.tree import leaves

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, f"store_{task}"),
                                     world), rank=rank, world_size=world)
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    out = {}
    qcfg = get_config("qwen1_5_4b").reduced()
    qmodel = Model.from_config(qcfg)

    def qparams():
        return qmodel.init(torch.Generator().manual_seed(SEED), "cpu",
                           master=True)

    if task == "eight":
        mesh = make_debug_mesh(8, model=4, device="cpu")
        base = get_config("granite_moe_1b_a400m").reduced()
        env = AxisEnv(batch=("data",), model="model",
                      sizes=tuple(mesh_sizes(mesh).items()), mesh=mesh)
        full = {k: torch.from_numpy(inp[k]) for k in
                ("router", "wg", "wu", "wd")}
        specs = {"router": P(), "wg": P("model", None, None),
                 "wu": P("model", None, None), "wd": P("model", None, None)}
        p = {k: distribute_tensor(v, mesh, placements(specs[k], mesh),
                                  src_data_rank=None)
             for k, v in full.items()}
        x = torch.from_numpy(inp["x"])
        xd = distribute_tensor(x, mesh, placements(P("data", None, None),
                                                   mesh), src_data_rank=None)
        for tag, cf in (("cf8", 8.0), ("cfdef", base.capacity_factor)):
            cfg = dataclasses.replace(base, capacity_factor=cf)
            with axis_env(env):
                y, aux = moe.moe_fwd(p, cfg, xd, impl="a2a")
            out[f"a2a_{tag}"] = y.full_tensor().numpy()
            out[f"aux_{tag}"] = aux.full_tensor().numpy()
            out[f"dense_{tag}"] = moe.moe_fwd(full, cfg, x,
                                              impl="dense")[0].numpy()
            _moe_grads(inp, cfg, mesh, out, tag)
            if tag == "cf8":
                _oracle_grads(inp, cfg, 2, out, tag)
        # two experts per rank: (data=4, model=2)
        qmesh = make_debug_mesh(8, model=2, device="cpu")
        env2 = AxisEnv(batch=("data",), model="model",
                       sizes=tuple(mesh_sizes(qmesh).items()), mesh=qmesh)
        p2 = {k: distribute_tensor(v, qmesh, placements(specs[k], qmesh),
                                   src_data_rank=None)
              for k, v in full.items()}
        x2 = distribute_tensor(x, qmesh, placements(P("data", None, None),
                                                    qmesh),
                               src_data_rank=None)
        with axis_env(env2):
            y, _ = moe.moe_fwd(p2, dataclasses.replace(
                base, capacity_factor=8.0), x2, impl="a2a")
        out["a2a_el2"] = y.full_tensor().numpy()
        # the vocab-parallel lookup: table rows over model, tokens over
        # data; the output and the table's gradient, whole
        from repro_torch.models.sharding import embedding, shard
        table = torch.from_numpy(inp["table"]).requires_grad_()
        tok = torch.from_numpy(inp["tok"])
        dt = distribute_tensor(table.detach(), qmesh, placements(
            P("model", None), qmesh), src_data_rank=None).requires_grad_()
        dtok = distribute_tensor(tok, qmesh, placements(P("data", None),
                                                        qmesh),
                                 src_data_rank=None)
        with axis_env(env2):
            y = shard(embedding(dtok, dt), "batch", "seq", None)
        (y * distribute_tensor(torch.from_numpy(inp["tw"]), qmesh,
                               y.placements, src_data_rank=None)).sum() \
            .backward()
        out["embed"] = y.full_tensor().detach().numpy()
        out["embed_grad"] = dt.grad.full_tensor().numpy()
        out["embed_grad_placed"] = np.array(
            [str(p) for p in dt.grad.placements])
        params = qparams()
        shards = leaves(shd.param_shardings(params, qmesh, qcfg))
        dp = [distribute_tensor(t.detach(), qmesh, s.placements,
                                src_data_rank=None)
              for t, s in zip(leaves(params), shards)]
        CheckpointStore(os.path.join(tmp, "ckpt_port")).save(1, dp)
    elif task == "two":
        _ssd_grads(inp, make_debug_mesh(2, model=1, device="cpu"), out)
    else:
        g = torch.from_numpy(inp["g"][rank])
        from repro_torch.optim import compressed_psum
        out["psum"] = compressed_psum(g, dist.group.WORLD).numpy()
        mesh = make_debug_mesh(4, model=2, device="cpu")
        like = qparams()
        sh = shd.param_shardings(like, mesh, qcfg)
        for name in ("ckpt_port", "ckpt_ref"):
            tree, manifest = CheckpointStore(os.path.join(tmp, name)) \
                .restore(like, shardings=sh)
            got = leaves(tree)
            out[f"{name}_step"] = np.array(manifest["step"])
            out[f"{name}_mesh"] = np.array(
                [t.device_mesh.size() for t in got])
            out[f"{name}_placed"] = np.array(
                [list(t.placements) == s.placements
                 for t, s in zip(got, leaves(sh))])
            for i, t in enumerate(got):
                out[f"{name}_{i}"] = t.full_tensor().detach().numpy()
        for i, t in enumerate(leaves(like)):
            out[f"init_{i}"] = t.detach().numpy()
        # two experts per rank: the gradients against the dense oracle,
        # then the pre-fix control, then one train step
        cfg = dataclasses.replace(get_config("granite_moe_1b_a400m")
                                  .reduced(), capacity_factor=8.0)
        _moe_grads(inp, cfg, mesh, out, "m2")
        _oracle_grads(inp, cfg, 2, out, "m2")
        fixed = moe.block, moe.unblock
        moe.block, moe.unblock = _prefix_control(mesh)
        try:
            _moe_grads(inp, cfg, mesh, out, "prefix")
        finally:
            moe.block, moe.unblock = fixed
        _train_step(inp, mesh, out)
    if rank == 0:
        np.savez(os.path.join(tmp, f"out_{task}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.checkpoint import CheckpointStore
from repro.launch import shardings as shd
from repro.launch.mesh import make_debug_mesh
from repro.models import moe as MO
from repro.models.registry import Model, get_config
from repro.models.sharding import AxisEnv, axis_env
from repro.optim.grad_compress import compressed_psum
try:
    from jax import shard_map as _sm
    shard_map = _sm.shard_map if hasattr(_sm, "shard_map") else _sm
except ImportError:
    from jax.experimental.shard_map import shard_map
tmp = sys.argv[1]
inp = np.load(os.path.join(tmp, "inputs.npz"))
out = {}
mesh = jax.make_mesh((2, 4), ("data", "model"))
base = get_config("granite_moe_1b_a400m").reduced()
p = {k: jnp.asarray(inp[k]) for k in ("router", "wg", "wu", "wd")}
x = jnp.asarray(inp["x"])
env = AxisEnv(batch=("data",), model="model",
              sizes=tuple(mesh.shape.items()), mesh=mesh)
for tag, cf in (("cf8", 8.0), ("cfdef", base.capacity_factor)):
    cfg = dataclasses.replace(base, capacity_factor=cf)
    with mesh, axis_env(env):
        y, aux = jax.jit(lambda pp, xx: MO.moe_fwd(pp, cfg, xx,
                                                   impl="a2a"))(p, x)
    out["a2a_" + tag] = np.asarray(y)
    out["aux_" + tag] = np.asarray(aux)
    # the gradients of sum(y**2) + aux, at the model's weight scale
    pg = {k: jnp.asarray(inp["g_" + k]) for k in ("router", "wg", "wu", "wd")}

    def loss(pp, xx, cfg=cfg):
        y, aux = MO.moe_fwd(pp, cfg, xx, impl="a2a")
        return jnp.sum(jnp.square(y)) + aux

    with mesh, axis_env(env):
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(pg, x)
    for k in pg:
        out["grad_%s_%s" % (tag, k)] = np.asarray(gp[k])
    out["grad_%s_x" % tag] = np.asarray(gx)
mesh2 = jax.make_mesh((4, 2), ("data", "model"))
env2 = AxisEnv(batch=("data",), model="model",
               sizes=tuple(mesh2.shape.items()), mesh=mesh2)
cfg = dataclasses.replace(base, capacity_factor=8.0)
with mesh2, axis_env(env2):
    y, _ = jax.jit(lambda pp, xx: MO.moe_fwd(pp, cfg, xx, impl="a2a"))(p, x)
out["a2a_el2"] = np.asarray(y)
m4 = Mesh(np.array(jax.devices()[:4]), ("pod",))
sm = shard_map(lambda g: compressed_psum(g[0], "pod")[None], mesh=m4,
               in_specs=(P("pod"),), out_specs=P("pod"))
out["psum"] = np.asarray(jax.jit(sm)(jnp.asarray(inp["g"])))
cfg = get_config("qwen1_5_4b").reduced()
model = Model.from_config(cfg)
params = model.init(jax.random.PRNGKey(0))
devs = np.array(jax.devices()[:4]).reshape(2, 2)
mesh4 = Mesh(devs, ("data", "model"))
sh4 = shd.param_shardings(params, mesh4, cfg)
tree, manifest = CheckpointStore(os.path.join(tmp, "ckpt_port")).restore(
    params, shardings=sh4)
leaves = jax.tree.leaves(tree)
out["port_step"] = np.array(manifest["step"])
out["port_mesh"] = np.array([l.sharding.mesh.devices.size for l in leaves])
for i, l in enumerate(leaves):
    out["port_%d" % i] = np.asarray(l)
mesh8 = make_debug_mesh(8, model=2)
store = CheckpointStore(os.path.join(tmp, "ckpt_ref"))
store.save(2, jax.device_put(params, shd.param_shardings(params, mesh8, cfg)),
           blocking=True)
for i, l in enumerate(jax.tree.leaves(params)):
    out["ref_%d" % i] = np.asarray(l)
np.savez(os.path.join(tmp, "out_reference.npz"), **out)
print(json.dumps({"ok": True}))
"""


def _spawn(world: int, task: str, tmp: str, join: bool = True):
    import torch.multiprocessing as mp
    return mp.spawn(_job, args=(world, task, tmp), nprocs=world, join=join)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    _inputs(os.path.join(tmp, "inputs.npz"))
    _spawn(8, "eight", tmp)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    two = _spawn(2, "two", tmp, join=False)       # beside the reference
    got = subprocess.run([sys.executable, "-c", REFERENCE, tmp], env=env,
                         capture_output=True, text=True, timeout=600)
    while not two.join():
        pass
    assert got.returncode == 0, got.stderr[-3000:]
    assert json.loads(got.stdout.strip().splitlines()[-1])["ok"]
    _spawn(4, "four", tmp)
    return {name: dict(np.load(os.path.join(tmp, f"{name}.npz")))
            for name in ("out_eight", "out_reference", "out_four",
                         "out_two", "inputs")}


# --------------------------------------------------------------------- #
# the expert-parallel plan                                               #
# --------------------------------------------------------------------- #
def test_a2a_matches_dense_without_drops(runs):
    """At ``capacity_factor=8.0`` no token is dropped, so the a2a plan
    on 8 ranks is the dense oracle (``tests/test_models.py:135``)."""
    got = runs["out_eight"]
    np.testing.assert_allclose(got["a2a_cf8"], got["dense_cf8"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tag", ["cf8", "cfdef"])
def test_a2a_matches_reference_a2a(runs, tag):
    """The port's a2a against the reference's ``shard_map`` plan on the
    same mesh and weights, with and without drops (at the default
    capacity each rank keeps at most 8 of its tokens per expert); the
    aux loss is its pmean over every mesh dim."""
    got, ref = runs["out_eight"], runs["out_reference"]
    np.testing.assert_allclose(got[f"a2a_{tag}"], ref[f"a2a_{tag}"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[f"aux_{tag}"], ref[f"aux_{tag}"],
                               rtol=1e-5)
    if tag == "cfdef":        # drops: the plan no longer equals dense
        assert np.abs(got["a2a_cfdef"] - got["dense_cfdef"]).max() > 1e-3


def test_a2a_with_two_experts_per_rank(runs):
    """At (data=4, model=2) each rank owns two of the four experts.  The
    port regroups the received (sender, expert) blocks expert-major before
    the FFN and back after it, and still equals the dense oracle.  The
    reference reshapes them without that transpose
    (``repro/models/moe.py:198, 205-207``), which pairs tokens with the
    wrong experts and ranks once a rank holds more than one expert: its
    output misses the oracle there (pinned, not repaired)."""
    got, ref = runs["out_eight"], runs["out_reference"]
    np.testing.assert_allclose(got["a2a_el2"], got["dense_cf8"],
                               rtol=1e-4, atol=1e-4)
    assert np.abs(ref["a2a_el2"] - got["dense_cf8"]).max() > 1e-2


def test_vocab_parallel_lookup(runs):
    """The embedding of a table sharded along its vocab over the model
    dim, for tokens sharded over the data dim, on 8 ranks: the rows and
    the table's gradient (of a weighted sum) equal the whole lookup's;
    the gradient stays sharded along the vocab over the model dim, a
    partial sum over the data dim's batch shards."""
    got, inp = runs["out_eight"], runs["inputs"]
    np.testing.assert_array_equal(got["embed"], inp["table"][inp["tok"]])
    want = np.zeros_like(inp["table"])
    np.add.at(want, inp["tok"], inp["tw"])
    np.testing.assert_allclose(got["embed_grad"], want, rtol=1e-6,
                               atol=1e-6)
    assert list(got["embed_grad_placed"]) == ["P(sum)", "S(0)"]


# --------------------------------------------------------------------- #
# gradients of weights shared across ranks                               #
# --------------------------------------------------------------------- #
GRADS = WEIGHTS + ("x",)


@pytest.mark.parametrize("tag", ["cf8", "cfdef"])
@pytest.mark.parametrize("name", GRADS)
def test_a2a_grads_match_reference(runs, tag, name):
    """The a2a plan's gradients at (data=2, model=4) equal the reference's
    ``jax.grad`` of its ``shard_map`` plan on the same mesh shape, with
    and without drops: each rank's gradient of the router (held by all 8)
    and of its experts (held by the 2 ranks of its data dim) is a partial
    sum that the port adds over them, as shard_map's transpose does."""
    got, ref = runs["out_eight"], runs["out_reference"]
    np.testing.assert_allclose(got[f"grad_{tag}_{name}"],
                               ref[f"grad_{tag}_{name}"], rtol=1e-4,
                               atol=1e-8)


@pytest.mark.parametrize("mesh", ["eight", "four"])
@pytest.mark.parametrize("name", GRADS)
def test_a2a_grads_match_dense_oracle(runs, mesh, name):
    """Without drops the a2a plan's gradients equal the dense oracle's
    (its aux the mean of the batch shards'), at (data=2, model=4) and at
    (data=2, model=2), where each rank holds two experts."""
    tag = "cf8" if mesh == "eight" else "m2"
    got = runs[f"out_{mesh}"]
    np.testing.assert_allclose(got[f"grad_{tag}_{name}"],
                               got[f"oracle_{tag}_{name}"], rtol=1e-4,
                               atol=1e-8)


def test_a2a_grads_before_the_fix_miss(runs):
    """The control: with ``to_local()``'s default gradient placements
    (each rank's partial gradient taken as the whole) the expert weights'
    gradients at (data=2, model=2) miss the oracle by more than 10%."""
    got = runs["out_four"]
    want = got["oracle_m2_wg"]
    miss = np.abs(got["grad_prefix_wg"] - want).max() / np.abs(want).max()
    assert miss > 0.1, miss


def test_a2a_train_step_matches_plain(runs):
    """One ``make_train_step`` step with ``TrainConfig(moe_impl="a2a")``
    on DTensors at (data=2, model=2) leaves the parameters of the same
    step forced plain on one process (scatter, no drops) within 1e-5
    relative (per leaf, in the L2 norm: AdamW's first step divides each
    gradient by its own size, so an entry whose gradient is within a few
    float32 roundings of zero moves by up to the step size, lr, on either
    side), with the same loss and gradient norm."""
    got = runs["out_four"]
    n = len([k for k in got if k.startswith("step_plain_")])
    assert n > 0
    for i in range(n):
        a, b = got[f"step_a2a_{i}"], got[f"step_plain_{i}"]
        assert a.shape == b.shape
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= 1e-5, (i, err)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[f"metric_a2a_{k}"],
                                   got[f"metric_plain_{k}"], rtol=1e-5)
    assert float(got["metric_plain_lr"]) > 0


@pytest.mark.parametrize("name", ["in_proj", "conv_w", "conv_b", "a_log",
                                  "dt_bias", "d_skip", "norm_w", "out_proj",
                                  "x"])
def test_ssd_grads_match_plain(runs, name):
    """``ssd_fwd`` of reduced mamba2 on DTensors at (data=2, model=1):
    every parameter's gradient (``a`` and ``d_skip`` reach every batch
    shard whole, and their gradients are summed over the shards) within
    1e-5 relative of the same function on plain tensors."""
    got = runs["out_two"]
    a, b = got[f"ssd_{name}"], got[f"ssd_plain_{name}"]
    assert np.abs(b).max() > 0
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


# --------------------------------------------------------------------- #
# the compressed reduction                                               #
# --------------------------------------------------------------------- #
def test_compressed_psum_matches_reference(runs):
    """The int8 payload summed as int32 is the reference's bit for bit,
    and the float32 result within 1e-6; the ranks' inputs differ in
    scale by 4000x, so the smaller ones' payloads round to the common
    scale."""
    got, ref = runs["out_four"]["psum"], runs["out_reference"]["psum"]
    for row in ref:                 # every device ends with the same sum
        np.testing.assert_array_equal(row, ref[0])
    s_max = _s_max(runs)
    payload = np.round(got / s_max).astype(np.int32)
    np.testing.assert_array_equal(
        payload, np.round(ref[0] / s_max).astype(np.int32))
    assert 0 < np.abs(payload).max() <= 127 * RANKS_PSUM
    np.testing.assert_allclose(got, ref[0], rtol=1e-6, atol=0)


def _s_max(runs):
    """The common scale: the largest rank's ``max|g| / 127 + 1e-12``."""
    from repro_torch.optim.grad_compress import _quantize
    return max(float(_quantize(torch.from_numpy(g))[1])
               for g in runs["inputs"]["g"])


# --------------------------------------------------------------------- #
# the elastic restore                                                    #
# --------------------------------------------------------------------- #
def test_elastic_restore_eight_to_four(runs):
    """Saved by 8 ranks (4, 2), restored by a new job of 4 ranks (2, 2):
    every leaf equal, a DTensor over the 4-rank mesh, placed by the
    rules of that mesh (``tests/test_elastic.py``)."""
    got = runs["out_four"]
    n = len([k for k in got if k.startswith("init_")])
    assert int(got["ckpt_port_step"]) == 1
    assert (got["ckpt_port_mesh"] == 4).all() and len(
        got["ckpt_port_mesh"]) == n
    assert got["ckpt_port_placed"].all()
    for i in range(n):
        np.testing.assert_array_equal(got[f"ckpt_port_{i}"],
                                      got[f"init_{i}"])


def test_elastic_restore_across_packages(runs):
    """The reference restores the port's 8-rank checkpoint onto its
    4-device mesh, and the port's 4 ranks restore the reference's."""
    got, ref = runs["out_four"], runs["out_reference"]
    n = len([k for k in got if k.startswith("init_")])
    assert int(ref["port_step"]) == 1 and (ref["port_mesh"] == 4).all()
    assert int(got["ckpt_ref_step"]) == 2 and got["ckpt_ref_placed"].all()
    for i in range(n):
        np.testing.assert_array_equal(ref[f"port_{i}"], got[f"init_{i}"])
        np.testing.assert_array_equal(got[f"ckpt_ref_{i}"], ref[f"ref_{i}"])


# --------------------------------------------------------------------- #
# the BLAS-offload mesh                                                  #
# --------------------------------------------------------------------- #
def test_offload_mesh_over_device_tiers(tmp_path):
    """Four logical tiers wrap onto the one real device; the mesh is 1-D
    ``("blas",)`` over the distinct devices
    (``tests/test_multidevice.py:431``)."""
    import torch.distributed as dist
    from repro_torch.core import memspace
    from repro_torch.launch import mesh
    space = memspace.for_device(torch.device("cpu"), 4)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with memspace.installed(space):
            devs = mesh.offload_devices()
            assert devs == [torch.device("cpu")] * 4
            m = mesh.make_offload_mesh()
        assert m.mesh_dim_names == ("blas",)
        assert m.size(0) >= 1 and m.device_type == "cpu"
    finally:
        dist.destroy_process_group()
