"""One training step of reduced mamba2 on real collectives against the
same step on plain tensors.

A gloo job of 4 ranks (``torch.multiprocessing`` spawn, a ``FileStore``
in the test's temporary directory) at ``(data=2, model=2)`` runs
``make_train_step`` on DTensors: the parameters placed by
``param_shardings``, the moments by ``opt_shardings``, the batch over
data.  Rank 0 runs the same step on plain tensors from the same seeded
weights and batch.  Two cells:

* ``width0``: mamba2's own width-0 MLP (``d_ff=0``), 2 rows per batch
  shard.  The loss does not reach the MLP's leaves, whose gradients
  must still come placed as their parameters for the in-place update;
* ``rows``: the reduced MLP (``d_ff=128``) and 1 row per batch shard,
  fewer than the model dim's 2 ranks, where DTensor splits the positions
  over ``model`` and a product's flattened rows would carry a strided
  shard (``models.sharding.rows``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SEED = 0
T = 16
STEP = 10                   # the step count: lr 0.5 x peak
CELLS = {"width0": (0, 4), "rows": (128, 2)}       # d_ff, batch


def _step(cfg, batch, mesh):
    """One step from the seeded weights: on DTensors over ``mesh``, or on
    plain tensors where ``mesh`` is None.  (params, mu, nu, metrics)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import shardings as shd
    from repro_torch.launch import specs
    from repro_torch.models.registry import Model
    from repro_torch.models.sharding import P, axis_env, placements
    from repro_torch.optim import AdamW, init_compression
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.tree import leaves, unflatten
    model = Model.from_config(cfg)
    params = model.init(torch.Generator().manual_seed(SEED), "cpu",
                        master=True)
    opt = AdamW()
    step = make_train_step(model, TrainConfig(), opt, total_steps=100)
    state = opt.init(params)
    if mesh is None:
        _, state, _, metrics = step(params, state, init_compression(params),
                                    batch, STEP)
    else:
        def place(t, s):
            return distribute_tensor(t.detach(), mesh, s.placements,
                                     src_data_rank=None)

        ps = leaves(shd.param_shardings(params, mesh, cfg))
        params = unflatten(params, [place(t, s).requires_grad_()
                                    for t, s in zip(leaves(params), ps)])
        os_ = shd.opt_shardings(state, mesh, cfg, params=params)
        state = type(state)(
            step=state.step,
            mu=[place(m, s) for m, s in zip(state.mu, os_.mu)],
            nu=[place(v, s) for v, s in zip(state.nu, os_.nu)])
        batch = {k: distribute_tensor(v, mesh, placements(
            P("data", None), mesh), src_data_rank=None)
            for k, v in batch.items()}
        with axis_env(specs.axis_env_for(mesh)):
            _, state, _, metrics = specs._implicit(step)(
                params, state, init_compression(params), batch, STEP)
        for p, m, v in zip(leaves(params), state.mu, state.nu):
            assert list(m.placements) == list(v.placements) == \
                list(p.placements), (p.shape, p.placements, m.placements)

    def whole(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return t.detach().numpy()

    return ([whole(t) for t in leaves(params)],
            [whole(t) for t in state.mu], [whole(t) for t in state.nu],
            {k: whole(v) for k, v in metrics.items()})


def _job(rank: int, world: int, tmp: str) -> None:
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import get_config

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    mesh = make_debug_mesh(world, model=2, device="cpu")
    out = {}
    rng = np.random.default_rng(SEED)
    for tag, (d_ff, b) in CELLS.items():
        cfg = dataclasses.replace(get_config("mamba2_1_3b").reduced(),
                                  d_ff=d_ff)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab, (b, T)).astype(np.int32))
            for k in ("tokens", "labels")}
        runs = {"mesh": _step(cfg, batch, mesh)}
        if rank == 0:
            runs["plain"] = _step(cfg, batch, None)
        for run, (params, mu, nu, metrics) in runs.items():
            for field, ts in (("p", params), ("mu", mu), ("nu", nu)):
                for i, t in enumerate(ts):
                    out[f"{tag}_{run}_{field}_{i}"] = t
            for k, v in metrics.items():
                out[f"{tag}_{run}_metric_{k}"] = v
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("ssd_train"))
    mp.spawn(_job, args=(4, tmp), nprocs=4, join=True)
    return dict(np.load(os.path.join(tmp, "out.npz")))


@pytest.mark.parametrize("field", ["p", "mu", "nu"])
@pytest.mark.parametrize("tag", list(CELLS))
def test_mesh_step_matches_plain(got, tag, field):
    """Every parameter and moment after the step on the mesh within 1e-5
    relative of the plain step's (per leaf, in the L2 norm: AdamW's first
    step divides each gradient by its own size, so an entry whose
    gradient is within a few float32 roundings of zero moves by up to
    lr either way).  The width-0 MLP's leaves are empty in both, and the
    moments of the norm before it zero in both."""
    n = len([k for k in got if k.startswith(f"{tag}_plain_{field}_")])
    assert n > 0
    empty = zero = 0
    for i in range(n):
        a = got[f"{tag}_mesh_{field}_{i}"]
        b = got[f"{tag}_plain_{field}_{i}"]
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if b.size == 0:
            empty += 1
            continue
        assert np.isfinite(a).all()
        scale = np.linalg.norm(b)
        if scale == 0:          # a leaf the loss does not reach
            assert not a.any(), i
            zero += 1
            continue
        err = np.linalg.norm(a - b) / scale
        assert err <= 1e-5, (i, err)
    assert empty == (3 if CELLS[tag][0] == 0 else 0)
    # without an MLP, the norm before it (``ln2``) takes no gradient
    assert zero == (1 if field != "p" and CELLS[tag][0] == 0 else 0)


@pytest.mark.parametrize("tag", list(CELLS))
def test_mesh_step_metrics_match_plain(got, tag):
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[f"{tag}_mesh_metric_{k}"],
                                   got[f"{tag}_plain_metric_{k}"],
                                   rtol=1e-5)
    assert float(got[f"{tag}_plain_metric_lr"]) > 0
