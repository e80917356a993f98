"""The mesh path's decode step at a tensor position, and its capture.

``launch/specs.py`` ``decode_step`` is the step of the dry run's decode
cells and of the card's mesh phase (``chip_smoke.py`` mesh (a) and (f));
on the card ``kernels.compat.GraphedStep`` warms it up, captures it in
one CUDA graph with its collectives and replays it, the position a
one-element int32 tensor on the device.  Here, on the CPU over a 1-rank
gloo group and a ``(data=1, model=1)`` mesh, reduced granite-moe
(float32, the a2a plan: two all-to-alls and the aux all-reduces per MoE
layer) runs the step eagerly, as the capture records it:

* at a tensor position it equals the step at host integer positions bit
  for bit, tokens and every cache leaf, on plain per-rank blocks (mesh
  (a)) and on DTensors placed by ``param_shardings`` and the cache specs
  (mesh (f));
* the DTensor step's tokens equal the plain blocks' step's.

``GraphedStep``'s handling of a call's arguments (copy, capture anew,
raise) and its owners' weak hold (``Server`` and ``Trainer`` free it
when they go) need no card and run here too.

A ``cuda``-marked test captures and replays both on a 1-rank NCCL group
(it skips here): tokens and cache bit for bit the eager step's, the
collectives and launches per replay from the capture's record, no host
sync in a replay.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.models.sharding import axis_env  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

BATCH, PROMPT, STEPS = 2, 16, 4
SEED = 0


def _group(path: str, backend: str, device=None):
    import torch.distributed as dist
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0,
                            world_size=1, device_id=device)


def _model():
    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m").reduced(),
                              prefill_fresh_kv=True)
    return Model.from_config(cfg)


def _setup(model, dev, dtensor: bool, mesh):
    """Parameters, a prefilled cache and the first decode token, on plain
    per-rank blocks or on DTensors over ``mesh``."""
    cfg = model.cfg
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).to(dev)
    cache = model.init_cache(BATCH, PROMPT + STEPS, torch.float32,
                             device=dev)
    if dtensor:
        params = specs.place_params(params, mesh, cfg)
        cache = specs.place_cache(cache, PROMPT + STEPS, mesh)
        prompt = specs._dist(prompt, specs.shd.NamedSharding(
            mesh, specs.P("data", None)))
    with axis_env(specs.axis_env_for(mesh)):
        tok, cache = specs.prefill_step(model, "a2a")(params, prompt, cache,
                                                      {})
    return params, cache, tok


def _decode(model, mesh, params, cache, tok, pos_of):
    """STEPS decode steps; ``pos_of(i)`` is step i's position argument."""
    step = specs.decode_step(model, "a2a")
    toks = []
    with axis_env(specs.axis_env_for(mesh)):
        for i in range(STEPS):
            tok, cache = step(params, tok[:, None], cache, pos_of(i))
            toks.append(tok)
    return torch.stack(toks, 1), cache


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    import torch.distributed as dist
    _group(str(tmp_path_factory.mktemp("gloo") / "store"), "gloo")
    try:
        yield make_debug_mesh(1, model=1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(gloo):
    model = _model()
    out = {}
    for kind in ("plain", "dtensor"):
        got = {}
        for how in ("host", "tensor"):
            params, cache, tok = _setup(model, "cpu", kind == "dtensor", gloo)
            pos = torch.zeros(1, dtype=torch.int32)

            def at(i, how=how, pos=pos):
                if how == "host":
                    return PROMPT + i
                pos.fill_(PROMPT + i)
                return pos

            toks, cache = _decode(model, gloo, params, cache, tok, at)
            got[how] = (_full(toks), [_full(x) for x in leaves(cache)])
        out[kind] = got
    return out


@pytest.mark.parametrize("kind", ["plain", "dtensor"])
def test_tensor_position_equals_host_position(runs, kind):
    """The step at a one-element int32 position tensor (the capture's)
    writes the cache with ``index_copy_`` and reads ``kv_len`` from it;
    it is the step at host integers bit for bit."""
    host, tensor = runs[kind]["host"], runs[kind]["tensor"]
    assert torch.equal(host[0], tensor[0])
    assert len(host[1]) == len(tensor[1]) > 0
    for a, b in zip(host[1], tensor[1]):
        assert torch.equal(a, b)
    assert host[0].dtype == torch.int32
    assert host[0].shape == (BATCH, STEPS)


def test_dtensor_step_equals_plain_blocks(runs):
    """On one rank the DTensor step (parameters placed by
    ``param_shardings``, the cache by the cache specs) computes the plain
    blocks' step: the same tokens and cache."""
    plain, dt = runs["plain"]["tensor"], runs["dtensor"]["tensor"]
    assert torch.equal(plain[0], dt[0])
    for a, b in zip(plain[1], dt[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "dtensor"])
def test_graphed_step_on_nccl(tmp_path, kind):
    """On the card over a 1-rank NCCL group: ``GraphedStep`` warms the
    step up, captures it with its collectives and replays it; tokens and
    cache bit for bit the eager step's at the same positions fed the same
    tokens; the capture's record holds 2 all-to-alls per MoE layer and
    the step's launches; a replay makes no host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from repro_torch.kernels import compat
    dev = torch.device("cuda", 0)
    _group(str(tmp_path / "store"), "nccl", dev)
    model = _model()
    step = compat.GraphedStep(specs.decode_step(model, "a2a"), dev,
                              fresh=(1,))
    try:
        mesh = make_debug_mesh(1, model=1, device="cuda")
        dtensor = kind == "dtensor"
        params, cache, tok = _setup(model, dev, dtensor, mesh)
        pos = torch.zeros(1, dtype=torch.int32, device=dev)
        toks = []
        with axis_env(specs.axis_env_for(mesh)):
            for i in range(STEPS):
                pos.fill_(PROMPT + i)
                if i == STEPS - 1:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    tok = step(params, tok[:, None], cache, pos)[0].clone()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                toks.append(tok)
        assert step.replays == STEPS - 1
        moe_layers = sum(model.cfg.is_moe_layer(i)
                         for i in range(model.cfg.n_layers))
        moves = {}
        for counters, m in step.record:
            if counters is compat.collectives:
                moves.update(m)
        assert moves.get("all_to_all_single") == 2 * moe_layers, moves
        # the eager step from Python, from the same prefill
        params, ecache, etok = _setup(model, dev, dtensor, mesh)
        ref, ecache = _decode(model, mesh, params, ecache, etok,
                              lambda i: PROMPT + i)
        assert torch.equal(_full(torch.stack(toks, 1)), _full(ref))
        for a, b in zip(leaves(cache), leaves(ecache)):
            assert torch.equal(_full(a), _full(b))
    finally:
        step.release()      # NCCL keeps its communicator for a live graph
        dist.destroy_process_group()


@pytest.mark.parametrize("change", ["none", "fresh", "shape", "dtype",
                                    "structure", "host value"])
def test_graphed_step_copies_or_captures_anew(change):
    """What ``GraphedStep`` does with a call's arguments against the
    capture's (``_copies``, no card needed): the graph's own tensors
    passed again copy nothing, a new fresh tensor of the same shape is
    copied in, another shape or dtype asks for a new capture (None), and
    another tree structure or host value raises."""
    from repro_torch.kernels import compat
    tok, cache = torch.zeros(2, 1), (torch.zeros(3), torch.zeros(4))
    step = compat.GraphedStep(lambda *a: a, "cpu", fresh=(0,))
    step.args = (tok, cache, "a2a")
    call = {"none": (tok, cache, "a2a"),
            "fresh": (torch.ones(2, 1), cache, "a2a"),
            "shape": (torch.ones(3, 1), cache, "a2a"),
            "dtype": (tok, (cache[0].double(), cache[1]), "a2a"),
            "structure": (tok, cache[:1], "a2a"),
            "host value": (tok, cache, "scatter")}[change]
    if change in ("structure", "host value"):
        with pytest.raises(ValueError):
            step._copies(call)
        return
    copies = step._copies(call)
    if change in ("shape", "dtype"):
        assert copies is None
    elif change == "fresh":
        assert len(copies) == 1 and copies[0][1] is tok
    else:
        assert copies == []


@pytest.mark.parametrize("owner", ["Server", "Trainer"])
def test_an_owner_frees_its_graphed_step_at_once(owner):
    """``Server`` and ``Trainer`` keep their ``GraphedStep``, whose step
    holds them weakly (``compat.weak_step``): a dropped owner frees the
    step, and on the card its graph, at once, without a garbage
    collection, which could come in the middle of another capture (where
    freeing a graph invalidates it)."""
    import gc
    import weakref
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.train import Server, ServeConfig, Trainer, TrainConfig
    model = _model()
    gc.disable()
    try:
        if owner == "Server":
            obj = Server(model, None, ServeConfig(), device="cpu")
        else:
            obj = Trainer(model, TokenPipeline(DataConfig(
                vocab=model.cfg.vocab, seq_len=8, global_batch=2)),
                TrainConfig(steps=1), device="cpu")
        step = weakref.ref(obj.graphed)
        assert obj.replays == 0
        del obj
        assert step() is None
    finally:
        gc.enable()
