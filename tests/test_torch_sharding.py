"""The port's sharding rules against the JAX reference's.

``repro_torch.models.sharding`` (``logical``, ``axis_env``, ``shard``)
and ``repro_torch.launch.shardings`` (``param_spec``, ``sanitize``,
``opt_shardings``, ``cache_spec``) are held to ``repro.models.sharding``
and ``repro.launch.shardings`` on the same inputs: every parameter path of
all ten reduced configs, the sanitize cases of
``tests/test_dryrun_small.py``, the ZeRO-1 moments and the cache specs.
The port's specs are its ``P`` tuples, the reference's PartitionSpecs
compared as tuples.  The reference's functions read only ``mesh.shape``
and ``mesh.axis_names``, so they get a stand-in mesh of the same sizes;
the port's run on a ``DeviceMesh`` over a fake process group of 8 ranks.
Last, ``launch/train.py --mesh single --dry-compile`` runs the dry run of
full-size qwen1.5-4b's ``train_4k`` cell, as the reference's launcher
does.
"""
import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch import shardings as jshd  # noqa: E402
from repro.models import sharding as jsharding  # noqa: E402
from repro.models.registry import ARCHS as JARCHS  # noqa: E402
from repro.models.registry import Model as JModel  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.launch.mesh import (batch_axes,  # noqa: E402
                                     make_debug_mesh)
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.registry import ARCHS, Model, get_config  # noqa
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.tree import paths  # noqa: E402


def _stand_in(sizes: dict):
    """What the reference's rules read of a mesh."""
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


@pytest.fixture(scope="module")
def mesh8():
    import torch.distributed as dist
    dryrun.fake_group(8)
    yield make_debug_mesh(8, model=2, device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def _jpaths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(jshd._path_names(p)), leaf) for p, leaf in flat]


# --------------------------------------------------------------------- #
# logical axes and the shard constraint                                  #
# --------------------------------------------------------------------- #
ENVS = {
    "single": dict(batch=("data",), model="model"),
    "multi": dict(batch=("pod", "data"), model="model"),
    "seq": dict(batch=("data",), model="model", seq="model"),
}
DIMS = [("batch", "seq", None), ("batch", "model", None, None),
        ("model", None, None), ("batch", None, "model", None), (),
        ("data", None)]


@pytest.mark.parametrize("env", list(ENVS))
def test_logical_matches_reference(env):
    kw = ENVS[env]
    assert tuple(sharding.logical(*DIMS[0])) == tuple(
        jsharding.logical(*DIMS[0]))          # no env bound: the default
    with sharding.axis_env(sharding.AxisEnv(**kw)), \
            jsharding.axis_env(jsharding.AxisEnv(**kw)):
        for dims in DIMS:
            assert tuple(sharding.logical(*dims)) == tuple(
                jsharding.logical(*dims)), dims
    assert sharding.get_env() is None and jsharding.get_env() is None


def test_axis_env_sizes_match_reference():
    sizes = (("pod", 2), ("data", 16), ("model", 16))
    env, jenv = sharding.AxisEnv(sizes=sizes), jsharding.AxisEnv(sizes=sizes)
    for name in ("pod", "data", "model", ("pod", "data"), "seq"):
        assert env.axis_size(name) == jenv.axis_size(name)


def test_shard_is_identity_without_env_or_for_plain_tensors():
    x = torch.ones(4, 6, 8)
    assert sharding.shard(x, "batch", "seq", None) is x
    with sharding.axis_env(sharding.AxisEnv(sizes=(("data", 4),
                                                   ("model", 2)))):
        assert sharding.shard(x, "batch", "seq", "model") is x
    jx = jax.numpy.ones((4, 6, 8))
    assert jsharding.shard(jx, "batch", "seq", None) is jx


@pytest.mark.parametrize("dims,shape", [
    (("batch", "seq", None), (8, 6, 8)),
    (("batch", None, "model"), (8, 6, 8)),
    (("batch", None, "model"), (6, 6, 7)),     # neither divides
    (("model", None, None), (4, 3, 8)),
    (("batch", "model", None, None), (4, 3, 5, 2)),
])
def test_shard_spec_matches_reference(monkeypatch, mesh8, dims, shape):
    """The spec the port redistributes to is the one the reference hands
    to ``with_sharding_constraint``, and the DTensor lands on it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, distribute_tensor
    sizes = (("data", 4), ("model", 2))
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    with jsharding.axis_env(jsharding.AxisEnv(sizes=sizes)):
        jsharding.shard(jax.numpy.ones(shape), *dims)
    env = sharding.AxisEnv(sizes=sizes, mesh=mesh8)
    with sharding.axis_env(env), FakeTensorMode():
        x = distribute_tensor(torch.ones(shape), mesh8,
                              [Replicate(), Replicate()],
                              src_data_rank=None)
        assert tuple(sharding._spec_for(x, dims)) == seen[0]
        y = sharding.shard(x, *dims)
    assert list(y.placements) == sharding.placements(seen[0], mesh8)


def test_placements_translate_specs(mesh8):
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.placements(sharding.P("data", None, "model"),
                               mesh8) == [Shard(0), Shard(2)]
    assert sharding.placements(sharding.P(None, ("data", "model")),
                               mesh8) == [Shard(1), Shard(1)]
    assert sharding.placements(sharding.P(), mesh8) == [Replicate()] * 2
    with pytest.raises(ValueError):
        sharding.placements(sharding.P(("model", "data")), mesh8)
    with pytest.raises(ValueError):
        sharding.placements(sharding.P("data", "data"), mesh8)


# --------------------------------------------------------------------- #
# sanitize, parameter, optimizer and cache rules                         #
# --------------------------------------------------------------------- #
def test_sanitize_cases_of_the_small_dryrun(mesh8):
    """``tests/test_dryrun_small.py:28-33``'s oracles, on the port's
    ``DeviceMesh`` and the reference's rules alike."""
    jm = _stand_in({"data": 4, "model": 2})
    P = sharding.P
    for spec, shape, fb, want in [
            (P("model", None), (7, 4), None, (None, None)),
            (P(None, None, "model", None, None), (2, 2, 3, 8, 16), {2: 4},
             (None, None, None, None, "model")),
            (P(("data", "model"), None), (8, 3), None,
             (("data", "model"), None)),
            (P(("data", "model"), None), (4, 3), None, (None, None))]:
        got = shd.sanitize(spec, shape, mesh8, fallbacks=fb)
        ref = jshd.sanitize(jax.sharding.PartitionSpec(*spec), shape, jm,
                            fallbacks=fb)
        assert tuple(got) == tuple(ref) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh8):
    """Every leaf path of the reduced config: the same names, the same
    rule's spec, and the same spec once sanitized on the (4, 2) mesh."""
    assert tuple(JARCHS) == tuple(ARCHS)
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    jshapes = jax.eval_shape(JModel.from_config(jcfg).init,
                             jax.random.PRNGKey(0))
    ref = {names: leaf for names, leaf in _jpaths(jshapes)}
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = Model.from_config(cfg).init(torch.Generator(), "cpu")
    got = dict(paths(params))
    assert list(got) == list(ref)
    jm = _stand_in({"data": 4, "model": 2})
    sharded = dict(paths(shd.param_shardings(params, mesh8, cfg)))
    for names, leaf in got.items():
        jleaf = ref[names]
        assert tuple(leaf.shape) == tuple(jleaf.shape), names
        spec = shd.param_spec(names, leaf, cfg)
        jspec = jshd.param_spec(
            [jax.tree_util.DictKey(n) for n in names], jleaf, jcfg)
        assert tuple(spec) == tuple(jspec), names
        jsan = jshd.sanitize(jspec, jleaf.shape, jm)
        assert tuple(sharded[names].spec) == tuple(jsan), names


def test_opt_shardings_zero_match_reference(monkeypatch, mesh8):
    """ZeRO-1 moments on the (4, 2) mesh: each moment's spec is the
    reference's (its rules run with specs in place of shardings)."""
    arch = "granite_moe_1b_a400m"
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    jshapes = jax.eval_shape(JModel.from_config(jcfg).init,
                             jax.random.PRNGKey(0))
    jopt = jax.eval_shape(JAdamW().init, jshapes)
    jm = _stand_in({"data": 4, "model": 2})
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = Model.from_config(cfg).init(torch.Generator(), "cpu",
                                             master=True)
        opt = AdamW().init(params)
    for zero in (False, True):
        ref = jshd.opt_shardings(jopt, jm, jcfg, zero=zero)
        got = shd.opt_shardings(opt, mesh8, cfg, params=params, zero=zero)
        assert tuple(got.step.spec) == tuple(ref.step) == ()
        for field in ("mu", "nu"):
            want = [tuple(s) for s in jax.tree.leaves(
                getattr(ref, field), is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))]
            assert [tuple(s.spec) for s in getattr(got, field)] == want
    assert any("data" in s.spec for s in got.mu)


@pytest.mark.parametrize("multi", [False, True])
def test_cache_and_batch_specs_match_reference(multi, mesh8):
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi
             else {"data": 16, "model": 16})
    jm = _stand_in(sizes)
    pm = types.SimpleNamespace(mesh_dim_names=tuple(sizes))
    assert batch_axes(pm) == jshd.batch_axes(jm)
    assert tuple(shd.batch_spec(pm)) == tuple(jshd.batch_spec(jm))
    for kind, nd in (("kv", 5), ("ssm", 5), ("conv", 4)):
        for seq in (False, True):
            assert tuple(shd.cache_spec(pm, kind, nd, seq_shard=seq)) == \
                tuple(jshd.cache_spec(jm, kind, nd, seq_shard=seq))
    with pytest.raises(ValueError):
        shd.cache_spec(pm, "bogus", 3)
    got = shd.batch_shardings({"tokens": (8, 5), "frames": (6, 3, 4)},
                              mesh8)
    assert tuple(got["tokens"].spec) == ("data", None)
    assert tuple(got["frames"].spec) == (None, None, None)


# --------------------------------------------------------------------- #
# the launcher's dry compile                                             #
# --------------------------------------------------------------------- #
def test_launch_train_mesh_dry_compile(capsys):
    """``--mesh single --dry-compile`` runs ``run_cell(arch, "train_4k")``
    on full-size qwen1.5-4b (``--reduced`` does not apply), over a fake
    group of 512 ranks, and returns 0; both rooflines print."""
    import os
    import torch.distributed as dist
    from repro_torch.launch import train as launch_train
    with contextlib.ExitStack() as stack:
        stack.callback(lambda: dist.is_initialized()
                       and dist.destroy_process_group())
        prev = os.environ.pop("DRYRUN_DEVICES", None)
        stack.callback(os.environ.update,
                       {} if prev is None else {"DRYRUN_DEVICES": prev})
        stack.callback(os.environ.pop, "DRYRUN_DEVICES", None)
        rc = launch_train.main(["--arch", "qwen1_5_4b", "--reduced",
                                "--mesh", "single", "--dry-compile"])
        assert dist.get_world_size() == 512
    out = capsys.readouterr().out
    assert rc == 0
    assert "[ok     ] qwen1_5_4b" in out and "single" in out
    assert "V5E " in out and "H100" in out
    assert np.isfinite(float(out.split("frac=")[1].split()[0]))
