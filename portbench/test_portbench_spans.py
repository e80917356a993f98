"""The reduction of the port's ``scilib.*`` spans (``portbench.spans``)
on a hand-built trace, each number worked out by hand, and what
``portbench.trace`` makes of the same trace."""
import pytest

from portbench import spans, trace
from portbench.test_portbench_harness import SEED, tiny

TID, DEV = 1, 9
STEPS = 2


def x(cat, name, ts, dur, corr=None, t=TID, **args):
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": t, "args": args}


def ann(name, ts, dur):
    return x("user_annotation", name, ts, dur)


#: two steps' worth: a dgemm whose operand moves again (a copy of 1000
#: B), then a getrf holding a panel (a graph launch of two kernels), its
#: swap and a zgemm whose kernel runs past the solver's end
EVENTS = [
    ann(trace.WINDOW_MARK, 0, 2000),
    ann("scilib.call.dgemm", 100, 500),
    ann("scilib.decide", 110, 20),
    ann("scilib.move.again", 150, 200),
    x("cuda_runtime", "cudaMemcpyAsync", 160, 5, corr=1),
    x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 170, 160, corr=1,
      t=DEV, bytes=1000),
    ann("scilib.compute", 400, 50),
    x("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=2),
    x("kernel", "dmma_f64_kernel", 460, 800, corr=2, t=DEV),
    ann("scilib.fence", 500, 10),
    ann("scilib.solver.getrf", 1300, 400),
    ann("scilib.panel", 1310, 90),
    x("cuda_runtime", "cudaGraphLaunch", 1320, 70, corr=3),
    x("kernel", "argmax", 1330, 50, corr=3, t=DEV),
    x("kernel", "elementwise", 1390, 60, corr=3, t=DEV),
    ann("scilib.swap", 1410, 30),
    x("cuda_runtime", "cudaLaunchKernel", 1420, 5, corr=4),
    x("kernel", "index_select", 1460, 10, corr=4, t=DEV),
    ann("scilib.call.zgemm", 1450, 150),
    ann("scilib.compute", 1460, 40),
    x("cuda_runtime", "cudaLaunchKernel", 1470, 5, corr=5),
    x("kernel", "zmma_kernel", 1500, 300, corr=5, t=DEV),
]
# device busy: [170,330] [460,1260] [1330,1380] [1390,1450] [1460,1470]
# [1500,1800]; idle gaps (midpoint): [0,170] (85) [330,460] (395, in the
# dgemm) [1260,1330] (1295) [1380,1390] (1385, in the panel's launch)
# [1450,1460] (1455, in the zgemm) [1470,1500] (1485, in its compute)
# [1800,2000] (1900)


def test_span_totals():
    r = spans.reduce(EVENTS)
    s = r.spans
    assert sorted(s) == sorted({
        "scilib.call.dgemm", "scilib.decide", "scilib.move.again",
        "scilib.compute", "scilib.fence", "scilib.solver.getrf",
        "scilib.panel", "scilib.swap", "scilib.call.zgemm"})
    dgemm = s["scilib.call.dgemm"]
    assert (dgemm.count, dgemm.host_s) == (1, pytest.approx(500e-6))
    assert dgemm.self_s == pytest.approx((500 - 20 - 200 - 50 - 10) * 1e-6)
    assert dgemm.device_s == pytest.approx((160 + 800) * 1e-6)
    assert dgemm.copy_s == pytest.approx(160e-6)
    assert dgemm.copy_bytes == 1000
    assert dgemm.reach_s == pytest.approx((1260 - 100) * 1e-6)
    assert dgemm.idle_s == pytest.approx(130e-6)
    compute = s["scilib.compute"]
    assert compute.count == 2
    assert compute.device_s == pytest.approx((800 + 300) * 1e-6)
    assert compute.idle_s == pytest.approx(30e-6)
    getrf = s["scilib.solver.getrf"]
    assert getrf.device_s == pytest.approx((50 + 60 + 10 + 300) * 1e-6)
    assert getrf.self_s == pytest.approx((400 - 90 - 30 - 150) * 1e-6)
    assert getrf.reach_s == pytest.approx((1800 - 1300) * 1e-6)
    assert getrf.idle_s == pytest.approx((10 + 10 + 30) * 1e-6)
    assert s["scilib.panel"].device_s == pytest.approx(110e-6)
    assert s["scilib.panel"].reach_s == pytest.approx((1450 - 1310) * 1e-6)
    assert s["scilib.swap"].device_s == pytest.approx(10e-6)
    assert s["scilib.fence"].reach_s == pytest.approx(10e-6)
    assert r.idle_s == pytest.approx(620e-6)
    assert r.idle_in_spans_s == pytest.approx(180e-6)
    assert r.call_children_s == pytest.approx({
        "scilib.decide": 20e-6, "scilib.move.again": 200e-6,
        "scilib.compute": 90e-6, "scilib.fence": 10e-6})


def test_metrics():
    got = spans.metrics(spans.reduce(EVENTS), STEPS)
    assert got == pytest.approx({
        "call_device_us": (160 + 800 + 300) / 2,
        "dispatch_self_us_per_call": (500 + 150 - 200 - 50 - 40) / 2,
        "link_ms_per_step": 160e-3 / STEPS,
        "moved_again_mb_per_step": 1000 / STEPS / 1e6,
        "solver_ms": 500e-3 / STEPS,
        "panel_ms": 110e-3 / STEPS,
        "idle_in_program_share": 100 * 180 / 620})


def test_no_span_reads_nothing_and_no_kind_reads_zero():
    plain = [e for e in EVENTS if not e["name"].startswith("scilib.")]
    assert spans.reduce(plain) is None
    assert spans.metrics(None, STEPS) == {}
    # calls ran, but no move, solver or panel
    calls = [e for e in EVENTS if e["ts"] < 1300]
    got = spans.metrics(spans.reduce(
        [e for e in calls if e["name"] != "scilib.move.again"]), STEPS)
    assert got["moved_again_mb_per_step"] == got["link_ms_per_step"] == 0
    assert got["solver_ms"] == got["panel_ms"] == 0
    assert got["call_device_us"] == pytest.approx(160 + 800)


def test_trace_profile_of_the_same_events():
    """``portbench.trace`` reads the spans' trace as any other: its
    idle gaps now name the port's spans."""
    p = trace.summarize(EVENTS, blas_bound_s=0.0)
    assert p.window_s == pytest.approx(2000e-6)
    assert p.busy_s == pytest.approx((160 + 800 + 50 + 60 + 10 + 300)
                                     * 1e-6)
    assert (p.blas_kernel_s, p.blas_calls) == (0.0, 0)
    assert dict(p.idle_gaps) == pytest.approx({
        "python": (170 + 70 + 200) * 1e-6,
        "scilib.call.dgemm": 130e-6,
        "scilib.compute": 30e-6,
        "scilib.panel > cudaGraphLaunch": 10e-6,
        "scilib.call.zgemm": 10e-6})
    assert p.device_ops[0] == ["dmma_f64_kernel", pytest.approx(800e-6)]


@pytest.mark.parametrize("workload", ["lsms.resident", "parsec.resident"])
def test_cell_traced_on_the_cpu(workload):
    """A tiny cell's traced steps hold the port's spans: calls, and the
    solver's under LSMS; no device, so no device time."""
    got = spans.run(tiny(workload), SEED, 2, "cpu")
    names = set(got["spans"])
    assert {"scilib.call.zgemm" if workload.startswith("lsms")
            else "scilib.call.dgemm", "scilib.decide", "scilib.compute",
            "scilib.fence"} <= names
    if workload.startswith("lsms"):
        assert {"scilib.solver.getrf", "scilib.solver.getrs",
                "scilib.panel", "scilib.swap"} <= names
        assert got["metrics"]["solver_ms"] > 0
    assert got["metrics"]["dispatch_self_us_per_call"] > 0
    assert got["metrics"]["call_device_us"] == 0
    assert got["profile"] is None          # no device activity
