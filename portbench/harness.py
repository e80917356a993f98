"""The benchmark's harness: one cell of ``BENCHMARK.json``, one run.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the configuration entry's ``file``): sizes,
  session settings, the ``app`` that runs it and the limits of its
  checks;
* ``traffic/<traffic>.json``: the mix's parameters (the steps checked,
  session settings it overrides);
* ``apps/<app>.py``: the application's step through ``repro_torch``;
  ``reference/<app>.py``: its inputs and its plain reference;
* ``metrics/<metric>.py``: a reader, ``read(window) -> float or None``;
  a metric ``<base>.<part>`` with no file of its own is read by
  ``metrics/<base>.py`` (``step_s.parsec`` by ``step_s.py``).

A run sets up (inputs from the seed, the session, warm-up steps), then
steps the application until ``seconds`` have passed, each step ending in
a host read of its result.  A sample of the steps, drawn from the seed,
keeps its outputs; once the window has closed, the peak memory is read
and the program is freed, the reference recomputes those steps and
:func:`run` compares them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    """The cell asks for more CUDA cards than this machine has."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT


@dataclasses.dataclass
class Window:
    """What a run measured, as the metric readers take it."""

    setup_s: float
    window_s: float
    times: List[float]               # each step's seconds, host clock
    flops_per_step: float            # portbench.counts
    counters: Dict[str, float]       # the program's counters, window delta
    spans_ms: Dict[str, List[float]]  # the benchmark's CUDA-event spans
    profile: object = None           # trace.Profile of the traced steps

    @property
    def steps(self) -> int:
        return len(self.times)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration and traffic files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"choose from {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=w["chips"], config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)], root=root)


def require_cards(chips: int) -> None:
    """Raise :class:`NoCard` unless CUDA has ``chips`` cards here: the
    benchmark measures the card and never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA cards, the cell "
                     f"asks for {chips}")


_READERS: Dict[Path, object] = {}


def reader(name: str, root: Path = ROOT):
    """The module of ``portbench/metrics/<name>.py`` under ``root``, or
    where there is none, of the name with its last ``.<part>`` dropped,
    and so on: one quantity split by the end-to-end metric it moves is
    one reader."""
    base = name
    path = root / "portbench" / "metrics" / f"{base}.py"
    while not path.is_file() and "." in base:
        base = base.rpartition(".")[0]
        path = root / "portbench" / "metrics" / f"{base}.py"
    if path not in _READERS:
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{base.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _READERS[path] = module
    return _READERS[path]


def app_module(cfg: dict):
    return importlib.import_module(f"portbench.apps.{cfg['app']}")


def ref_module(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['app']}")


def session_settings(cell: Cell) -> dict:
    """The configuration's session settings under the traffic's."""
    return {**cell.config["session"], **cell.traffic.get("session", {})}


class Probe:
    """The benchmark's own spans around the program's layers, handed to
    the application: CUDA-event spans (``span``) while ``timing``, and a
    profiler mark per application-level BLAS call (``blas``) with its
    bound from ``portbench.counts`` while ``profiling``."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.timing = False
        self.profiling = False
        self.bound_s = 0.0
        self._spans: Dict[str, list] = {}

    def blas(self, flops: float, nbytes: float):
        if not self.profiling:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        from portbench import counts, trace
        self.bound_s += counts.bound_s(flops, nbytes)
        return record_function(trace.BLAS_MARK)

    @contextlib.contextmanager
    def span(self, name: str):
        if not (self.timing and self.cuda):
            yield
            return
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._spans.setdefault(name, []).append((start, end))

    def spans_ms(self) -> Dict[str, List[float]]:
        if self._spans:
            import torch
            torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self._spans.items()}


class Reservoir:
    """A uniform sample of ``k`` steps' outputs, drawn from ``seed``
    while the steps come (Algorithm R), so a run keeps no more than
    ``k`` outputs whatever its length."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen = k, 0
        self.rng = random.Random(seed)
        self.slots: list = []

    def offer(self, index: int, outputs) -> None:
        self.seen += 1
        if len(self.slots) < self.k:
            self.slots.append((index, outputs))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.slots[j] = (index, outputs)

    def items(self) -> list:
        return sorted(self.slots, key=lambda s: s[0])


def counters(stats) -> Dict[str, float]:
    """Every field of the runtime's per-routine statistics
    (``RoutineStats``), summed over routines."""
    total: Dict[str, float] = {}
    for r in stats.per_routine.values():
        for f in dataclasses.fields(r):
            total[f.name] = total.get(f.name, 0) + getattr(r, f.name)
    return total


def check(cell: Cell, seed: int, device, samples: list) -> tuple:
    """Recompute each sampled step with the plain reference and compare:
    ({number: worst reading}, steps over a limit).  The reference makes
    its inputs anew from ``seed``."""
    ref = ref_module(cell.config)
    limits = cell.config["checks"]
    inputs = ref.make_inputs(cell.config, cell.traffic, seed, device,
                             steps=[index for index, _ in samples])
    worst: Dict[str, float] = {}
    failed = 0
    for index, outputs in samples:
        want = ref.reference(cell.config, cell.traffic, inputs, index)
        got = ref.compare(outputs, want)
        del want
        over = False
        for name, value in got.items():
            if math.isnan(value):
                value = math.inf
            worst[name] = max(worst.get(name, 0.0), value)
            over |= not value <= limits[name]
        failed += over
    return worst, failed


def device_info(device) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def card_state() -> str:
    """The card's name, power limit, SM clock, power draw and temperature,
    as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def forbidden_modules() -> List[str]:
    """The top-level names of :data:`FORBIDDEN` that this process has
    loaded, each compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: Optional[float] = None, log=print) -> dict:
    """One run of ``cell``: the result's dict, or raise.  ``t0`` is when
    the process started (set-up is timed from there)."""
    import torch

    from portbench import trace as tracing
    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    probe = Probe(cuda)
    app = app_module(cfg).App(cfg, traffic, seed, device, probe,
                              session_settings(cell))
    app.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sampler = Reservoir(traffic["sample_steps"], seed)
    probe.timing = trace
    before = counters(app.stats())
    times: List[float] = []
    bad = 0
    start = time.perf_counter()
    while True:
        s0 = time.perf_counter()
        index, value, outputs = app.step()
        s1 = time.perf_counter()
        times.append(s1 - s0)
        bad += not math.isfinite(value)
        sampler.offer(index, outputs)
        del outputs
        if s1 - start >= seconds:
            break
    window_s = s1 - start
    after = counters(app.stats())
    if cuda:
        log(f"card after the window: {card_state()}")
    order = sorted(times)
    log(f"setup {setup_s!r} s; window {window_s!r} s, {len(times)} steps; "
        f"step s min {order[0]!r} median {order[len(order) // 2]!r} max "
        f"{order[-1]!r}; each {[round(t, 4) for t in times]}")
    probe.timing = False
    spans = probe.spans_ms()
    profile = None
    if trace:
        profile = tracing.profile_steps(app, probe, cfg["trace_steps"])
    dev = device_info(device)
    flops = app.flops_per_step()
    app.close()
    del app
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    worst, failed = check(cell, seed, device, sampler.items())
    win = Window(setup_s=setup_s, window_s=window_s, times=times,
                 flops_per_step=flops,
                 counters={k: v - before.get(k, 0) for k, v in after.items()},
                 spans_ms=spans, profile=profile)
    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = reader(entry["name"], cell.root).read(win)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    limits = cfg["checks"]
    correct = (bad == 0 and failed == 0 and bool(sampler.slots)
               and set(worst) == set(limits))
    result = {"correct": correct, "attempted": len(times),
              "failed": bad + failed, "metrics": metrics, "device": dev}
    if trace and profile is not None:
        dev["busy_s"], dev["window_s"] = profile.busy_s, profile.window_s
        result["breakdown"] = {"device_ops": profile.device_ops,
                               "idle_gaps": profile.idle_gaps}
    result["checks"] = {k: {"value": worst.get(k, math.inf), "limit": v}
                        for k, v in limits.items()}
    return result

