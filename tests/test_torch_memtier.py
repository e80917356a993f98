"""The port's memtier simulator and autotuner against the reference's:
the same trace gives the same PolicyReport and the same recommendation,
the port's solver-tier traces replay to the live per-solver counters in
both packages, and the autotuner's lapack_nb dimension."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.trace import Trace as JTrace  # noqa: E402
from repro.memtier.simulator import MemTierSimulator as JSim  # noqa: E402
from repro.memtier.spec import SPECS as JSPECS  # noqa: E402
from repro.tools import autotune as jat  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.trace import Trace  # noqa: E402
from repro_torch.memtier import MemTierSimulator, PolicyReport  # noqa: E402
from repro_torch.memtier.spec import SPECS  # noqa: E402
from repro_torch.tools import autotune as at  # noqa: E402

MINI_TRACE = str(Path(__file__).resolve().parent / "data" / "mini_trace.json")
POLICIES = ("cpu", "memcopy", "counter", "dfu", "pinned")


def _report(rep) -> dict:
    return dataclasses.asdict(rep)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_report_equals_reference_on_mini_trace(policy):
    """Every field of the PolicyReport, floats included: the port's
    simulator is the reference's arithmetic over the port's residency
    store and trace."""
    want = JSim(JSPECS["gh200"], policy=policy).run(JTrace.load(MINI_TRACE))
    got = MemTierSimulator(SPECS["gh200"], policy=policy).run(
        Trace.load(MINI_TRACE))
    assert isinstance(got, PolicyReport)
    assert _report(got) == _report(want)


@pytest.mark.parametrize("policy", ("dfu", "memcopy"))
def test_capped_multi_device_replay_equals_reference(policy):
    kw = dict(policy=policy, threshold=300.0, device_bytes=64 << 20,
              n_devices=2 if policy == "dfu" else 1, evict="lfu")
    want = JSim(JSPECS["tpu-v5e"], **kw).run(JTrace.load(MINI_TRACE))
    got = MemTierSimulator(SPECS["tpu-v5e"], **kw).run(
        Trace.load(MINI_TRACE))
    assert _report(got) == _report(want)


def test_autotune_recommendation_equals_reference():
    """docs/PERF.md:420-424: dfu at threshold 810.7 on 4 devices, the
    same grid and the same printed recommendation in both packages."""
    want = jat.autotune(JTrace.load(MINI_TRACE))
    got = at.autotune(Trace.load(MINI_TRACE))
    assert (got.best.policy, round(got.best.threshold, 1),
            got.best.n_devices) == ("dfu", 810.7, 4)
    assert got.best.config == want.best.config
    assert [p.config for p in got.points] == [p.config for p in want.points]
    assert at.format_recommendation(got) == jat.format_recommendation(want)
    assert at.format_grid(got) == jat.format_grid(want)


def test_autotune_emit_config_runs_a_port_session(tmp_path, capsys):
    out = str(tmp_path / "tuned.json")
    assert at.main([MINI_TRACE, "--emit-config", out]) == 0
    assert f"config written to {out}" in capsys.readouterr().out
    cfg = OffloadConfig.load(out)
    best = at.autotune(Trace.load(MINI_TRACE)).best
    assert (cfg.policy, cfg.devices) == (best.policy, best.n_devices)
    assert cfg.resolved_threshold() == pytest.approx(best.threshold)
    rep = MemTierSimulator.from_config(cfg).run(Trace.load(MINI_TRACE))
    assert rep.moved_bytes == best.moved_bytes


# --------------------------------------------------------------------- #
# the port's solver-tier traces: live == replay, in both packages        #
# --------------------------------------------------------------------- #
def _lapack_workload():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.standard_normal((120, 120)) / 120
                        + np.eye(120))
    g = rng.standard_normal((96, 96)) / 96
    spd = torch.as_tensor(g @ g.T + np.eye(96))
    h = rng.standard_normal((48, 48))
    torch.linalg.solve(a, torch.as_tensor(rng.standard_normal((120, 5))))
    torch.linalg.cholesky(spd)
    torch.linalg.eigvalsh(torch.as_tensor((h + h.T) / 2))


@pytest.fixture(scope="module")
def solver_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("solvers") / "trace.json")
    with repro_torch.session(OffloadConfig(lapack=True, threshold=32.0,
                                           lapack_nb=32),
                             device="cpu") as s:
        _lapack_workload()
        live = {name: (sv.spans, sv.calls, sv.panel_calls)
                for name, sv in s.stats.solvers.items()}
        tagged = [(c.routine, c.solver_id) for c in s.trace if c.solver_id]
        s.trace.dump(path)
    return path, live, tagged


def test_live_equals_replay_per_solver(solver_run):
    """The acceptance bar of the reference (tests/test_solvers.py:
    258-275) on the port: the simulator replays the per-solver counters
    span for span and call for call."""
    path, live, _ = solver_run
    rep = MemTierSimulator(SPECS["gh200"], policy="dfu",
                           threshold=32.0).run(Trace.load(path))
    replay = {name: (d["spans"], d["calls"], d["panel_calls"])
              for name, d in rep.per_solver.items()}
    assert replay == live
    assert set(live) == {"gesv", "potrf", "syev"}
    assert rep.solver_spans == sum(v[0] for v in live.values()) == 3


def test_port_trace_replays_in_the_reference(solver_run):
    """The schema is shared: the port's dump loads in
    repro.core.trace.Trace with its solver tags and events, and
    repro.memtier replays it to the same per-solver counters."""
    path, live, tagged = solver_run
    loaded = JTrace.load(path)
    assert [(c.routine, c.solver_id) for c in loaded
            if c.solver_id] == tagged
    assert loaded.event_count("solver_begin") == 3
    assert loaded.event_count("solver_end") == 3
    rep = JSim(JSPECS["gh200"], policy="dfu", threshold=32.0).run(loaded)
    assert {name: (d["spans"], d["calls"], d["panel_calls"])
            for name, d in rep.per_solver.items()} == live
    port = MemTierSimulator(SPECS["gh200"], policy="dfu",
                            threshold=32.0).run(Trace.load(path))
    assert _report(port) == _report(rep)


def test_span_trace_roundtrip(solver_run, tmp_path):
    path, _, tagged = solver_run
    loaded = Trace.load(path)
    assert [(c.routine, c.solver_id) for c in loaded if c.solver_id] \
        == tagged
    assert all(c.solver in ("gesv", "potrf", "syev")
               for c in loaded if c.solver_id)
    again = str(tmp_path / "again.json")
    loaded.dump(again)
    assert json.loads(Path(again).read_text()) == \
        json.loads(Path(path).read_text())


# --------------------------------------------------------------------- #
# the autotuner's lapack_nb dimension                                    #
# --------------------------------------------------------------------- #
def _solver_trace(module, spans: int = 2, n: int = 512, nb: int = 64):
    """tests/test_solvers.py's synthetic LU trace, in either package."""
    t = module.Trace()
    el = 16
    tau = t.new_buffer(n * n * el, "tau")
    tm = t.new_buffer(n * 32 * el, "tmat")
    for s in range(spans):
        sid = f"gesv#{s}"
        t.record_event("solver_begin", sid, 0)
        for j0 in range(0, n, nb):
            jb = min(nb, n - j0)
            t.panel("z", n - j0, jb, tau, solver=sid)
            rem = n - j0 - jb
            if rem:
                t.trsm("z", jb, rem, tau, tau, solver=sid)
                t.gemm("z", rem, rem, jb, tau, tau, tau, solver=sid)
        t.trsm("z", n, 32, tau, tm, solver=sid)
        t.trsm("z", n, 32, tau, tm, solver=sid)
        t.record_event("solver_end", sid, 0)
    return t


class _Port:
    Trace = Trace


class _Ref:
    Trace = JTrace


def test_retile_lapack_regenerates_lu_spans():
    trace = _solver_trace(_Port)
    out = at.retile_lapack(trace, 128)
    assert at.retile_lapack(trace, 0) is trace
    panels = [c for c in out if c.routine.endswith("getf2")]
    assert len(panels) == 2 * (512 // 128)
    solves = [c for c in out if c.routine.endswith("trsm") and c.m == 512]
    assert len(solves) == 4
    assert out.buffer_sizes == trace.buffer_sizes
    assert out.event_count("solver_begin") == 2
    assert all(c.solver == "gesv" for c in out if c.solver_id)
    want = jat.retile_lapack(_solver_trace(_Ref), 128)
    assert [c.to_json() for c in out] == [c.to_json() for c in want]


def test_retile_leaves_spanfree_traces_alone():
    t = Trace()
    a = t.new_buffer(64 * 64 * 4, "A")
    t.gemm("s", 64, 64, 64, a, a, a)
    assert at.retile_lapack(t, 128) is t


def test_autotune_sweeps_nb_only_on_solver_traces():
    kw = dict(policies=("dfu",), device_counts=(1,), device_bytes=None)
    res = at.autotune(_solver_trace(_Port), **kw)
    assert {p.lapack_nb for p in res.points} == {0, 64, 128, 256}
    assert "nb" in at.format_grid(res).splitlines()[0]
    want = jat.autotune(_solver_trace(_Ref), **kw)
    assert res.best.config == want.best.config
    plain = Trace()
    a = plain.new_buffer(512 * 512 * 4, "A")
    for _ in range(4):
        plain.gemm("s", 512, 512, 512, a, a, a)
    res_off = at.autotune(plain, **kw)
    assert all(p.lapack_nb == 0 for p in res_off.points)


def test_autotune_nb_point_env_and_config():
    res = at.autotune(_solver_trace(_Port), policies=("dfu",),
                      device_counts=(1,), device_bytes=None,
                      lapack_nbs=(0, 128))
    p = next(p for p in res.points if p.lapack_nb == 128)
    assert p.env().get("SCILIB_LAPACK") == "1"
    assert p.env().get("SCILIB_LAPACK_NB") == "128"
    cfg = p.to_config()
    assert isinstance(cfg, OffloadConfig)
    assert cfg.lapack is True and cfg.lapack_nb == 128
    base = next(p for p in res.points if p.lapack_nb == 0)
    assert "SCILIB_LAPACK" not in base.env()
    with repro_torch.session(cfg, device="cpu") as s:
        assert s.config.lapack_nb == 128
