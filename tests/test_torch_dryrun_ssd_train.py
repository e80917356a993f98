"""The SSD models' training dry run on a fake mesh: the two faults that
kept mamba2's and jamba's ``train_4k`` cells from planning.

* **A leaf the loss does not reach.**  mamba2's MLP has width 0
  (``configs/mamba2_1_3b.py``, ``d_ff=0``): its leaves take no gradient,
  and the zeros that stand in for one must be placed as the leaf is, or
  the in-place AdamW update (which keeps each moment's placements)
  refuses them.  Every gradient reaches the update placed as its
  parameter (``train/loop.py`` ``_placed``), and an empty leaf adds no
  collective to the step.
* **Token rows strided over ``model``.**  Where a batch shard holds
  fewer rows than the ``model`` dim has ranks (256 rows over
  ``(pod, data) = (2, 16)`` against 16 model ranks in the two-pod
  mesh), DTensor splits the positions over ``model``; a product's
  operand flattened to rows then carries a strided shard, whose
  propagation reads data that fake tensors do not have (torch 2.13;
  2.11 refuses the flatten).  ``models.sharding.rows`` redistributes
  such an operand first.  The
  fault shows on 8 ranks with a batch of 4: ``(data=4, model=2)``.

Cells of reduced mamba2 run on ``make_debug_mesh(8, model=2)`` over a
fake process group of 8 ranks and CPU fake tensors, held to the
reference's oracle (``tests/test_dryrun_small.py``: status ``ok``,
``flops > 0``).  The gloo step against the plain one is in
``tests/test_torch_mesh_ssd_train.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "mamba2_1_3b"
#: 4 rows over data's 4 ranks: 1 row per batch shard, 2 model ranks
SMALL = specs.ShapeCell("train_b4", "train", 16, 4)


@pytest.fixture(scope="module")
def mesh8():
    import torch.distributed as dist
    dryrun.fake_group(8)
    yield make_debug_mesh(8, model=2, device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def _reduced(**kw) -> dict:
    """``run_cell``'s overrides that make mamba2 its ``reduced()``
    config, with ``kw`` on top."""
    full = get_config(ARCH)
    red = dataclasses.replace(full.reduced(), **kw)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


@pytest.fixture(scope="module")
def width0(mesh8):
    """The ``train_4k`` cell of reduced mamba2 with its own ``d_ff=0``,
    and what each ``AdamW.update`` of it (the cell and its two depth
    probes) saw: per leaf the parameter's shape and placements, the
    gradient's, and the moments' after the update."""
    seen = []
    update = adamw.AdamW.update

    def spy(self, grads, state, params, lr):
        out = update(self, grads, state, params, lr)
        seen.append([(tuple(p.shape), list(p.placements), list(g.placements),
                      list(m.placements), list(v.placements))
                     for p, g, m, v in zip(leaves(params), grads, state.mu,
                                           state.nu)])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(adamw.AdamW, "update", spy)
        rec = dryrun.run_cell(ARCH, "train_4k", False, mesh=mesh8,
                              overrides=_reduced(d_ff=0), verbose=False)
    return rec, seen


def test_width0_cell_plans(width0):
    rec, seen = width0
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["cost"]["flops"] > 0 and rec["cost_raw"]["flops"] > 0
    assert get_config(ARCH).d_ff == 0 and "d_ff" not in rec["overrides"]
    assert len(seen) == 3           # the cell, then the 1- and 2-group probes
    empty = [leaf for leaf in seen[0] if 0 in leaf[0]]
    assert len(empty) == 3          # wg, wu, wd
    assert any(p != [p[0]] * len(p) for _, p, _, _, _ in empty)


def test_width0_gradients_and_moments_placed_as_parameters(width0):
    """Every gradient reaching the update, and every moment after it,
    carries its parameter's placements (the moments by ``opt_shardings``
    without ZeRO are the parameters')."""
    _, seen = width0
    for run in seen:
        for shape, p, g, m, v in run:
            assert g == p, (shape, p, g)
            assert m == p and v == p, (shape, p, m, v)


def test_empty_leaves_add_no_collective(mesh8):
    """The gradient norm and the update over mamba2's three empty MLP
    leaves, placed as ``param_shardings`` places them, issue no
    collective: an empty leaf is passed over by ``global_norm``, and its
    zeros need no redistribution."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as shd
    cfg = get_config(ARCH)
    with FakeTensorMode(), implicit_replication():
        mlp = {k: torch.zeros((4,) + s) for k, s in
               (("wg", (64, 0)), ("wu", (64, 0)), ("wd", (0, 64)))}
        placed = [distribute_tensor(t, mesh8, shd.NamedSharding(
            mesh8, shd.sanitize(shd.param_spec(("blocks", "0", "mlp", k),
                                               t, cfg), t.shape,
                                mesh8)).placements)
            for k, t in mlp.items()]
        assert any(len(set(map(str, p.placements))) > 1 for p in placed)
        opt = adamw.AdamW()
        state = opt.init(placed)
        state = type(state)(step=state.step,
                            mu=[torch.zeros_like(p) for p in placed],
                            nu=[torch.zeros_like(p) for p in placed])
        grads = [torch.zeros_like(p) for p in placed]
        counter = dryrun.Counter()
        with dryrun._own_propagation_mode(), counter:
            adamw.global_norm(grads)
            opt.update(grads, state, placed, torch.tensor(1e-3))
    assert counter.coll == []


def test_rows_of_positions_split_over_model(mesh8):
    """A (B, T, n) DTensor whose positions are split over ``model`` (the
    batch shard of 1 row cannot be) flattens to rows without a strided
    shard: the split moves to the last dim, a plain ``Shard`` of the
    rows' columns; flattened as it is, it would carry one (torch 2.13)
    or be refused (torch 2.11)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.sharding import rows, unrows

    def strided(t):
        return any(type(p).__name__ == "_StridedShard"
                   for p in t.placements)

    with FakeTensorMode():
        x = distribute_tensor(torch.zeros(4, 64, 128), mesh8,
                              [Shard(0), Shard(1)])
        try:
            flat = x.reshape(-1, 128)
        except RuntimeError:        # torch 2.11 refuses the flatten
            pass
        else:                       # torch 2.13 makes a strided shard
            assert strided(flat)
        r = rows(x)
        assert tuple(r.shape) == (256, 128)
        assert list(r.placements) == [Shard(0), Shard(1)]
        # the last dim indivisible by model's 2 ranks: gathered there
        odd = distribute_tensor(torch.zeros(4, 64, 127), mesh8,
                                [Shard(0), Shard(1)])
        assert list(rows(odd).placements) == [Shard(0), Replicate()]
        # rows sharded as a product leaves them come back as (B, T, n)
        y = unrows(r, (4, 64))
        assert tuple(y.shape) == (4, 64, 128) and not strided(y)


def test_small_batch_cell_plans(mesh8):
    """L's cell: reduced mamba2 training at 1 row per batch shard on
    ``(data=4, model=2)``, which ended in ``aten._local_scalar_dense``
    in the backward of the SSD's input projection before the fix."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(specs.SHAPES, SMALL.name, SMALL)
        rec = dryrun.run_cell(ARCH, SMALL.name, False, mesh=mesh8,
                              overrides=_reduced(), verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["cost"]["flops"] > 0 and rec["cost_raw"]["flops"] > 0
    assert rec["cost"]["flops"] == rec["cost_raw"]["flops"]
    assert sum(rec["collectives"].values()) > 0
