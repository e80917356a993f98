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


def _inputs(path: str) -> None:
    from repro_torch.models.registry import get_config
    cfg = get_config("granite_moe_1b_a400m").reduced()
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    rng = np.random.default_rng(SEED)

    def w(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    scales = np.array([1.0, 3.0, 0.01, 40.0], np.float32)[:, None, None]
    np.savez(path, router=w(d, e), wg=w(e, d, ff), wu=w(e, d, ff),
             wd=w(e, ff, d), x=rng.standard_normal((B, T, d)).astype(
                 np.float32),
             g=(rng.standard_normal((RANKS_PSUM, 64, 33)) * scales).astype(
                 np.float32),
             table=rng.standard_normal((16, 6)).astype(np.float32),
             tok=rng.integers(0, 16, (8, 5)),
             tw=rng.standard_normal((8, 5, 6)).astype(np.float32))


# --------------------------------------------------------------------- #
# the gloo jobs                                                          #
# --------------------------------------------------------------------- #
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


def _spawn(world: int, task: str, tmp: str) -> None:
    import torch.multiprocessing as mp
    mp.spawn(_job, args=(world, task, tmp), nprocs=world, join=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    _inputs(os.path.join(tmp, "inputs.npz"))
    _spawn(8, "eight", tmp)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    got = subprocess.run([sys.executable, "-c", REFERENCE, tmp], env=env,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    assert json.loads(got.stdout.strip().splitlines()[-1])["ok"]
    _spawn(4, "four", tmp)
    return {name: dict(np.load(os.path.join(tmp, f"{name}.npz")))
            for name in ("out_eight", "out_reference", "out_four",
                         "inputs")}


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
