"""The port's dry run (``launch/specs.py``, ``launch/dryrun.py``) and its
roofline model (``roofline/analysis.py``) on the CPU.

Cells of reduced configs run on ``make_debug_mesh(8, model=2)`` over a
fake process group of 8 ranks and CPU fake tensors.  The reference's own
small dry run (``tests/test_dryrun_small.py``) fails on this JAX at the
vocab-parallel gather, so there is no live output to compare with; the
port is held to that test's oracles (``status`` ok, ``flops > 0``) and
to invariants of its own counts:

* a count's useful share, model FLOPs over the ranks' counted FLOPs, lies
  in (0, 1]: every model product is counted at least once, so a share
  above 1 means a product went uncounted;
* a cell that shards over the 2-way ``model`` dim issues collectives;
* the reference's depth fit (``extrapolated_cost``), kept, equals the
  full-depth count the port's Python layer loop gives directly.

``collective_bytes`` and ``roofline_terms`` are held to the reference's
on the same HLO text and numbers.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.roofline import analysis as jroof  # noqa: E402

from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.registry import Model, get_config  # noqa: E402
from repro_torch.models.sharding import axis_env  # noqa: E402
from repro_torch.roofline import analysis as roof  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


@pytest.fixture(scope="module")
def mesh8():
    import torch.distributed as dist
    dryrun.fake_group(8)
    yield make_debug_mesh(8, model=2, device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def _reduced(arch: str) -> dict:
    """``run_cell``'s ``overrides`` that turn the config into its
    ``reduced()`` one.  The enc-dec one keeps as many encoder layers as
    decoder layers, as the full whisper-tiny has (4 and 4): the depth fit
    (``_with_groups``, the reference's ``dryrun.py:62-63``) scales both
    together."""
    full = get_config(arch)
    red = full.reduced()
    if red.family == "encdec":
        red = dataclasses.replace(red, encoder_layers=red.n_layers)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


CELLS = [
    ("qwen1_5_4b", "train_4k", "scatter"),
    ("granite_moe_1b_a400m", "decode_32k", "scatter"),
    ("granite_moe_1b_a400m", "decode_32k", "a2a"),
    ("mamba2_1_3b", "decode_32k", "scatter"),
    ("whisper_tiny", "prefill_32k", "scatter"),
]


@pytest.fixture(scope="module")
def records(mesh8):
    return {c: dryrun.run_cell(c[0], c[1], False, mesh=mesh8,
                               overrides=_reduced(c[0]), moe_impl=c[2],
                               verbose=False)
            for c in CELLS}


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_run_cell_reduced_on_debug_mesh(records, cell):
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 8 and rec["mesh"] == "4x2"
    assert rec["cost"]["flops"] > 0 and rec["cost_raw"]["flops"] > 0
    for key in ("roofline", "roofline_h100"):
        assert 0.0 < rec[key]["useful_flops_ratio"] <= 1.0, rec[key]
    # collectives on the 2-way model dim; the a2a plan's own all-to-alls
    assert sum(rec["collectives"].values()) > 0
    assert ("all-to-all" in rec["collectives"]) == (cell[2] == "a2a")
    mem = rec["memory"]
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert isinstance(mem["generated_code_size_in_bytes"], str)


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_extrapolated_cost_equals_direct_count(records, cell):
    """The layer stack is a Python loop, so the fit from one and two
    layer groups lands on the full-depth count: the FLOPs exactly; bytes
    and collective bytes within 1e-5, since at two layer groups, where
    the stacked leaves' layer dim equals the model dim's size, DTensor
    reduces a few of the optimizer's per-leaf sums differently (qwen's
    train cell: 8 more all-reduces of 64 KB; 1e-6 of its bytes)."""
    rec = records[cell]
    fit, raw = rec["cost"], rec["cost_raw"]
    assert fit["flops"] == raw["flops"]
    assert fit["bytes accessed"] == pytest.approx(raw["bytes accessed"],
                                                  rel=1e-5)
    assert rec["coll_bytes_fit"] == pytest.approx(
        sum(rec["collectives"].values()), rel=1e-5)
    assert set(rec["probes"]) == {"probe_k1", "probe_k2"}


def test_build_cell_places_arguments(mesh8):
    """A train cell's parameters, moments and batch are DTensors over
    fake tensors, placed by the sharding rules; nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    cfg = get_config("granite_moe_1b_a400m").reduced()
    model = Model.from_config(cfg)
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        specs.param_structs(model, mesh8)
    with axis_env(specs.axis_env_for(mesh8)), FakeTensorMode():
        cell = specs.build_cell(model, "g", "train_4k", mesh8, zero=True)
        params, opt, comp, batch, step = cell.args
        want = leaves(shd.param_shardings(params, mesh8, cfg))
        for p, s in zip(leaves(params), want):
            assert isinstance(p.to_local(), FakeTensor)
            assert list(p.placements) == s.placements
            assert p.requires_grad
        zero = shd.opt_shardings(opt, mesh8, cfg, params=params, zero=True)
        assert [list(m.placements) for m in opt.mu] == \
            [s.placements for s in zero.mu]
        assert len(comp.residual) == len(leaves(params))
        assert tuple(batch["tokens"].shape) == (256, 4096)
        assert tuple(batch["tokens"].to_local().shape) == (64, 4096)
        assert step == 0
        with pytest.raises(ValueError, match="unevenly"):
            specs._dist(torch.zeros(7, 4), shd.NamedSharding(
                mesh8, shd.P("data", None)))


def test_long_500k_skips_quadratic_models(mesh8):
    cfg = get_config("qwen1_5_4b")
    with pytest.raises(specs.CellSkipped):
        specs.check_cell(cfg, specs.SHAPES["long_500k"])
    specs.check_cell(get_config("mamba2_1_3b"), specs.SHAPES["long_500k"])
    rec = dryrun.run_cell("qwen1_5_4b", "long_500k", False, mesh=mesh8,
                          overrides=_reduced("qwen1_5_4b"), verbose=False)
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


@pytest.mark.parametrize("arch", ["qwen2_5_32b", "granite_moe_1b_a400m",
                                  "whisper_tiny"])
@pytest.mark.parametrize("shape", list(specs.SHAPES))
def test_model_flops_match_reference_formula(arch, shape):
    """6 N D for training, 2 N_active D for inference, from the same
    parameter count as the reference's config."""
    sh = specs.SHAPES[shape]
    total, active = jget_config(arch).param_count()
    tokens = sh.global_batch * (1 if sh.kind == "decode" else sh.seq)
    want = (6.0 if sh.kind == "train" else 2.0) * active * tokens
    assert dryrun.model_flops_for(get_config(arch), sh) == want


# --------------------------------------------------------------------- #
# roofline                                                               #
# --------------------------------------------------------------------- #
HLO = """
HloModule m
  %p0 = bf16[16,4096,320]{2,1,0} parameter(0)
  %ar = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %x), to_apply=%sum
  %ags = (bf16[8,128]{1,0}, bf16[64,128]{1,0}) all-gather-start(bf16[8,128]{1,0} %y), dimensions={0}
  %agd = bf16[64,128]{1,0} all-gather-done(%ags)
  %rs = f32[128]{0} reduce-scatter(f32[1024]{0} %z), dimensions={0}
  %a2a = (s32[4,16]{1,0}, s32[4,16]{1,0}) all-to-all(s32[4,16]{1,0} %u, s32[4,16]{1,0} %v)
  %cp = u8[100]{0} collective-permute-start(u8[100]{0} %w), source_target_pairs={{0,1}}
  %dot = f32[10,10]{1,0} dot(f32[10,10]{1,0} %a, f32[10,10]{1,0} %b)
"""


def test_collective_bytes_matches_reference():
    got = roof.collective_bytes(HLO)
    assert got == jroof.collective_bytes(HLO)
    assert got == {"all-reduce": 1024 * 512 * 4,
                   "all-gather": (8 + 64) * 128 * 2,
                   "reduce-scatter": 128 * 4,
                   "all-to-all": 2 * 4 * 16 * 4,
                   "collective-permute": 100}
    for text in ("s64[3,5]", "(f16[2], pred[7])", "c128[4]", "token[]"):
        assert roof._shape_bytes(text) == jroof._shape_bytes(text)


def test_collective_log_sums_by_kind():
    log = [("all-gather", 10), ("all-reduce", 4), ("all-gather", 6),
           ("all-to-all", 8)]
    assert roof.collective_bytes_of(log) == {"all-gather": 16,
                                             "all-reduce": 4,
                                             "all-to-all": 8}


@pytest.mark.parametrize("cost,coll", [
    ({"flops": 3.9e15, "bytes accessed": 2.1e12}, 7.5e9),
    ({"flops": 1.0e11, "bytes accessed": 9.0e11}, 0.0),
    ({"flops": 2.0e12, "bytes accessed": 1.0e9}, 4.0e12),
    (None, None),
])
def test_roofline_terms_match_reference(cost, coll):
    kw = dict(arch="a", shape="s", mesh_name="single", chips=256,
              cost=cost, hlo_text=HLO, model_flops=5.0e17,
              coll_bytes=coll)
    assert roof.roofline_terms(**kw).row() == jroof.roofline_terms(**kw).row()
    assert roof.V5E == jroof.V5E
    h = roof.roofline_terms(**kw, spec=roof.H100)
    flops = (cost or {}).get("flops", 0.0)
    assert h.t_compute == flops / 989.0e12
    assert h.t_memory == (cost or {}).get("bytes accessed", 0.0) / 3.35e12
