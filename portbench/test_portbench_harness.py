"""The harness on the port's simulated CPU tiers at tiny sizes: each
cell's run and every metric reader, the faults a run must catch, a cell,
traffic or metric added as files, and the refusal to run without a card.
"""
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, trace

ROOT = Path(__file__).resolve().parent.parent
SIZES = {"lsms": dict(n=48, nrhs=4, atoms_per_node=2, energies=3, tpool=3,
                      warmup_steps=2, trace_steps=2),
         "parsec": dict(ngrid=64, nstates=16, nblock=4, products_per_block=3,
                        warmup_steps=2, trace_steps=2)}
CELLS = ("lsms.resident", "parsec.resident")
#: readers that read the device: without one they find nothing
DEVICE_ONLY = {"lu_ms", "blas_roofline", "idle_share"}


def base(name):
    return name.split(".")[0]
SEED = 2 ** 31 + 101


def tiny(workload, root=ROOT):
    cell = harness.load_cell(workload, root)
    cfg = {**cell.config, **SIZES[cell.config["app"]]}
    cfg["session"] = {**cfg["session"], "threshold": 1.0, "lapack_nb": 16}
    return dataclasses.replace(cell, config=cfg, traffic={
        **cell.traffic, "sample_steps": 3})


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_and_reports_its_metrics(workload, traced):
    cell = tiny(workload)
    r = harness.run(cell, SEED, 0.2, traced, "cpu", log=lambda m: None)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(cell.config["checks"])
    app = cell.config["app"]
    names = set(r["metrics"])
    if not traced:
        assert names == {m["name"] for m in cell.end_to_end}
        assert r["metrics"][f"step_s.{app}"]["value"] > 0
        assert r["metrics"]["setup_s"]["value"] > 0
    else:
        # no device here: the trace's readers and the CUDA spans find
        # nothing, and their metrics are left out, never 0
        assert names == {m["name"] for m in cell.per_layer
                         if base(m["name"]) not in DEVICE_ONLY}
        assert r["metrics"][f"dispatch_us_per_call.{app}"]["value"] > 0
        assert r["metrics"][f"step_mfu.{app}"]["value"] > 0
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("workload", CELLS)
def test_resident_traffic_moves_nothing_in_the_window(workload):
    """Set-up moves each host-born input once; the window's steps find
    them all resident."""
    cell = tiny(workload)
    cell.per_layer = [m for m in cell.per_layer
                      if base(m["name"]) == "link_mb_per_step"]
    r = harness.run(cell, SEED, 0.2, True, "cpu", log=lambda m: None)
    (value,) = [m["value"] for m in r["metrics"].values()]
    assert value == 0.0


def test_readers_on_a_window():
    prof = trace.Profile(window_s=3.0, busy_s=1.5, blas_kernel_s=0.8,
                         blas_bound_s=0.4, blas_calls=3, device_ops=[],
                         idle_gaps=[], untraced_s=2.0)
    w = harness.Window(setup_s=7.0, window_s=10.0,
                       times=[0.1] * 89 + [0.2] * 11, flops_per_step=6.7e11,
                       counters={"calls": 400, "seconds": 0.02,
                                 "bytes_in": 3e6, "bytes_out": 1e6,
                                 "transient_bytes": 0},
                       spans_ms={"lu": [400.0, 420.0]}, profile=prof)
    want = {"setup_s": 7.0, "step_s": 0.1, "step_p90_s": 0.2,
            "dispatch_us_per_call": 50.0, "link_mb_per_step": 0.04,
            "lu_ms": 410.0, "blas_roofline": 50.0, "idle_share": 25.0,
            "step_mfu": 10.0}
    for name, value in want.items():
        assert harness.reader(name).read(w) == pytest.approx(value), name
        # a split metric is read by its quantity's reader
        assert harness.reader(f"{name}.parsec").read(w) == \
            pytest.approx(value), name
    empty = dataclasses.replace(w, spans_ms={}, profile=None)
    for name in ("lu_ms", "blas_roofline", "idle_share"):
        assert harness.reader(name).read(empty) is None


def test_trace_reduction():
    """Busy time is the union of device activity in the window; a BLAS
    call's kernels are those its launches (by correlation) started;
    copies count as busy but not as a call's kernels; gaps go to the
    innermost host op."""
    tid = 1

    def x(cat, name, ts, dur, corr=None, t=tid):
        args = {} if corr is None else {"correlation": corr}
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": t, "args": args}
    events = [
        x("user_annotation", trace.WINDOW_MARK, 0, 1000),
        x("user_annotation", trace.BLAS_MARK, 10, 50),
        x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=7),
        x("cuda_runtime", "cudaMemcpyAsync", 30, 5, corr=8),
        x("kernel", "gemm_kernel", 100, 300, corr=7, t=9),
        x("gpu_memcpy", "Memcpy HtoD", 50, 40, corr=8, t=9),
        x("cuda_runtime", "cudaLaunchKernel", 600, 5, corr=9),
        x("kernel", "other", 610, 90, corr=9, t=9),
        x("cpu_op", "aten::item", 700, 250),
        x("cuda_runtime", "cudaMemcpyAsync", 720, 220),
    ]
    p = trace.summarize(events, blas_bound_s=1e-4)
    assert p.window_s == pytest.approx(1e-3)
    assert p.busy_s == pytest.approx((40 + 300 + 90) * 1e-6)
    assert p.blas_kernel_s == pytest.approx(300e-6)
    assert p.blas_calls == 1
    assert p.device_ops[0] == ["gemm_kernel", pytest.approx(300e-6)]
    labels = dict(p.idle_gaps)
    assert labels == pytest.approx({
        "aten::item > cudaMemcpyAsync": 300e-6, "python": 220e-6,
        "portbench.blas > cudaLaunchKernel": 50e-6})
    assert p.idle_gaps[0][0] == "aten::item > cudaMemcpyAsync"
    assert trace.summarize([e for e in events if e["cat"] != "kernel"
                            and e["cat"] != "gpu_memcpy"], 1.0) is None


def _faults():
    """Faults planted in the port's own code, under the timed path."""
    from repro_torch.core import lapack
    from repro_torch.kernels import gemm
    plain = gemm.gemm_plain
    getrs = lapack.getrs

    def half_k(a, b, **kw):       # half of the batch, the mean of the rest
        k = a.shape[-1] // 2
        return 2 * plain(a[..., :k], b[..., :k, :], **kw)

    def altered(a, b, **kw):      # one answer altered where it is made
        out = plain(a, b, **kw)
        out.view(-1)[0] += out.abs().max() * 1e-3
        return out
    first = {}

    def unchanged(lu, piv, b):    # a step that returns its state unchanged
        if "x" not in first:
            first["x"] = getrs(lu, piv, b)
        return first["x"].clone()
    calls = {"n": 0}

    def one_product(a, b, **kw):  # the second product of each step
        out = plain(a, b, **kw)      # altered (3 a step at the tiny size)
        calls["n"] += 1
        if calls["n"] % 3 == 2:
            out.view(-1)[-1] += out.abs().max() * 1e-3
        return out
    return {"half_k": (gemm, "gemm_plain", half_k),
            "altered": (gemm, "gemm_plain", altered),
            "unchanged": (lapack, "getrs", unchanged),
            "one_product": (gemm, "gemm_plain", one_product)}


FAULTS = [("lsms.resident", "half_k"), ("lsms.resident", "altered"),
          ("lsms.resident", "unchanged"), ("parsec.resident", "half_k"),
          ("parsec.resident", "altered"), ("parsec.resident", "one_product")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(workload, fault,
                                                     monkeypatch):
    module, name, fn = _faults()[fault]
    monkeypatch.setattr(module, name, fn)
    r = harness.run(tiny(workload), SEED, 0.2, False, "cpu",
                    log=lambda m: None)
    assert not r["correct"] and r["failed"] > 0, r["checks"]


def _copy_tree(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_cell_traffic_and_metric_added_as_files_are_found(tmp_path):
    """A later change adds a traffic file, a metric reader and their
    entries; no file that is there is edited."""
    bench = _copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    (tmp_path / "portbench" / "traffic" / "memcopy.json").write_text(
        json.dumps({"why": "Mem-Copy: the baseline policy",
                    "sample_steps": 2, "session": {"policy": "memcopy"}}))
    (tmp_path / "portbench" / "metrics" / "calls_per_step.py").write_text(
        "def read(w):\n    return w.counters['calls'] / w.steps\n")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "parsec.resident" in m.get("workloads", []):
            m["workloads"].append("parsec.memcopy")
    bench["workloads"].append({"name": "parsec.memcopy", "chips": 1,
                               "config": "parsec_93536x2400",
                               "traffic": "memcopy", "why": "test"})
    bench["per_layer"].append({"name": "calls_per_step", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "interception",
                               "moves": "step_s.parsec",
                               "workloads": ["parsec.memcopy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny("parsec.memcopy", tmp_path)
    assert harness.session_settings(cell)["policy"] == "memcopy"
    r = harness.run(cell, SEED, 0.2, True, "cpu", log=lambda m: None)
    assert r["correct"]
    assert r["metrics"]["calls_per_step"]["value"] == 3
    # Mem-Copy stages Psi and the block in and the product out per call
    assert r["metrics"]["link_mb_per_step.parsec"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no result: the
    measurement never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "parsec.resident", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 3, out.stderr
    assert out.stdout.strip() == ""
    assert "is_available" in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    """In a directory holding BENCHMARK.json and portbench/ alone the
    command fails and prints no result."""
    _copy_tree(tmp_path)
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lsms.resident",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
