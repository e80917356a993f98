"""The port's own spans on the profiler's clock: the ``scilib.*`` ranges
that ``repro_torch`` records at its layer boundaries while a profiler
runs (``repro_torch.core.spans``), reduced from a chrome trace of the
traced steps, and the per-layer numbers that read them.

For each span name, over the window's instances on the window's thread:
``count``; ``host_s``; ``self_s`` (host seconds less its direct
``scilib.*`` children's); ``device_s``, ``copy_s`` and ``copy_bytes``
(the kernels, copies and memsets whose launches lie inside, matched by
correlation id as :mod:`portbench.trace` matches the BLAS marks, CUDA
graph launches included; the copies alone; their ``bytes``);
``reach_s`` (from each instance's start to its own end or, where
later, the end of the last device operation launched inside it);
``idle_s`` (the window's device-idle gaps whose midpoint lies
inside).  A device operation or a gap counts under every span that
holds it, nested ones included.

The harness reads none of this yet (:mod:`portbench.trace` keeps no
events past its :class:`~portbench.trace.Profile`).  Run it on its own
from the root of a checkout, on the card::

    python3 -m portbench.spans --workload <cell> --seed <n> [--steps k] \
        [--before b]

which sets the cell up as a run does, runs ``b`` steps (as a run's
window would; PARSEC's blocks come round every 75), times ``k`` steps
(the cell's ``trace_steps`` by default) without the profiler, profiles
``k`` more and prints one JSON object: the cell's :class:`~portbench.trace.Profile`
fields, :func:`metrics` and the reduction per span name.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

from portbench.trace import DEVICE_CATS, LAUNCH_CATS, WINDOW_MARK, _union

PREFIX = "scilib."


@dataclasses.dataclass
class Span:
    """One span name's totals over the window, in seconds and bytes."""

    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    copy_s: float = 0.0
    copy_bytes: int = 0
    reach_s: float = 0.0
    idle_s: float = 0.0


@dataclasses.dataclass
class Reduction:
    """The window's spans by name, with what the shares divide by."""

    spans: Dict[str, Span]
    idle_s: float             # the window's device-idle seconds
    idle_in_spans_s: float    # of them, gaps whose midpoint a span holds
    #: per direct child name, the host seconds it covers of each call
    #: span (``scilib.call.*``), summed over calls
    call_children_s: Dict[str, float]


def _end(e: dict) -> float:
    return e["ts"] + e["dur"]


def _push(spans: List[dict], stack: List[int], i: int) -> None:
    """Put span ``i`` on ``stack``, a chain of nested spans, above the
    innermost one that holds it."""
    while stack and _end(spans[stack[-1]]) < _end(spans[i]):
        stack.pop()
    stack.append(i)


def _stacks(spans: List[dict], points: List[float]) -> List[List[int]]:
    """For each of ``points`` (sorted), the indices into ``spans`` (one
    thread's, so nested; sorted by start, longer first) of the spans
    that hold it, outermost first."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i]["ts"] <= p:
            _push(spans, stack, i)
            i += 1
        while stack and _end(spans[stack[-1]]) < p:
            stack.pop()
        out.append(list(stack))
    return out


def _parents(spans: List[dict]) -> List[int]:
    """The index of each span's innermost holder, or -1."""
    out, stack = [], []
    for i in range(len(spans)):
        _push(spans, stack, i)
        out.append(stack[-2] if len(stack) > 1 else -1)
    return out


def reduce(events: List[dict]) -> Optional[Reduction]:
    """The ``scilib.*`` spans of the trace's window; None where the
    trace holds no window mark or no such span in it."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    window = next((e for e in marks if e["name"] == WINDOW_MARK), None)
    if window is None:
        return None
    w0, w1, tid = window["ts"], _end(window), window["tid"]
    spans = sorted((e for e in marks if e["tid"] == tid
                    and e["name"].startswith(PREFIX)
                    and w0 <= e["ts"] <= w1),
                   key=lambda e: (e["ts"], -e["dur"]))
    if not spans:
        return None
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    by_corr = collections.defaultdict(list)
    for e in device:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            by_corr[c].append(e)
    launches = sorted((e for e in events if e.get("cat") in LAUNCH_CATS
                       and e.get("tid") == tid
                       and e.get("args", {}).get("correlation") in by_corr),
                      key=lambda e: e["ts"])
    dev_us = [0.0] * len(spans)
    copy_us = [0.0] * len(spans)
    nbytes = [0] * len(spans)
    reach = [_end(s) for s in spans]
    for launch, holders in zip(launches,
                               _stacks(spans, [e["ts"] for e in launches])):
        for d in by_corr[launch["args"]["correlation"]]:
            copy = d["cat"] == "gpu_memcpy"
            size = int(d.get("args", {}).get("bytes", 0)) if copy else 0
            for i in holders:
                dev_us[i] += d["dur"]
                if copy:
                    copy_us[i] += d["dur"]
                    nbytes[i] += size
                reach[i] = max(reach[i], _end(d))
    # the window's idle gaps, as portbench.trace finds them
    busy = _union([(max(e["ts"], w0), min(_end(e), w1)) for e in device
                   if e["ts"] < w1 and _end(e) > w0])
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle_us = [0.0] * len(spans)
    in_spans = 0.0
    for (a, b), holders in zip(gaps, _stacks(spans, [(a + b) / 2
                                                     for a, b in gaps])):
        for i in holders:
            idle_us[i] += b - a
        in_spans += (b - a) if holders else 0.0
    # direct children: the innermost holder of each span's start
    child_us = [0.0] * len(spans)
    call_children: Dict[str, float] = collections.defaultdict(float)
    for i, p in enumerate(_parents(spans)):
        if p >= 0:
            child_us[p] += spans[i]["dur"]
            if spans[p]["name"].startswith(PREFIX + "call."):
                call_children[spans[i]["name"]] += spans[i]["dur"] * 1e-6
    out: Dict[str, Span] = {}
    for i, s in enumerate(spans):
        t = out.setdefault(s["name"], Span())
        t.count += 1
        t.host_s += s["dur"] * 1e-6
        t.self_s += (s["dur"] - child_us[i]) * 1e-6
        t.device_s += dev_us[i] * 1e-6
        t.copy_s += copy_us[i] * 1e-6
        t.copy_bytes += nbytes[i]
        t.reach_s += (reach[i] - s["ts"]) * 1e-6
        t.idle_s += idle_us[i] * 1e-6
    return Reduction(spans=out, idle_s=sum(b - a for a, b in gaps) * 1e-6,
                     idle_in_spans_s=in_spans * 1e-6,
                     call_children_s=dict(call_children))


def _total(r: Reduction, prefix: str, field: str) -> float:
    return sum(getattr(s, field) for n, s in r.spans.items()
               if n.startswith(prefix))


def metrics(r: Optional[Reduction], steps: int) -> Dict[str, float]:
    """The per-layer numbers of the spans over ``steps`` traced steps,
    each under its base name; empty where the steps held no span."""
    if r is None or steps <= 0:
        return {}
    calls = sum(s.count for n, s in r.spans.items()
                if n.startswith(PREFIX + "call."))
    covered = sum(v for n, v in r.call_children_s.items()
                  if n.startswith(PREFIX + "move.")
                  or n == PREFIX + "compute")
    moves = PREFIX + "move."
    again = r.spans.get(moves + "again", Span())
    return {
        "call_device_us": (_total(r, PREFIX + "call.", "device_s")
                           / calls * 1e6 if calls else 0.0),
        "dispatch_self_us_per_call": (
            (_total(r, PREFIX + "call.", "host_s") - covered) / calls * 1e6
            if calls else 0.0),
        "link_ms_per_step": _total(r, moves, "copy_s") / steps * 1e3,
        "moved_again_mb_per_step": again.copy_bytes / steps / 1e6,
        "solver_ms": _total(r, PREFIX + "solver.", "reach_s") / steps * 1e3,
        "panel_ms": (r.spans.get(PREFIX + "panel", Span()).device_s
                     / steps * 1e3),
        "idle_in_program_share": (100.0 * r.idle_in_spans_s / r.idle_s
                                  if r.idle_s > 0 else 0.0),
    }


def profile_events(app, probe, steps: int) -> tuple:
    """Time ``steps`` steps of ``app`` on the host clock, then run as
    many under the profiler with the window and BLAS marks on, as
    :func:`portbench.trace.profile_steps` does, which keeps no events:
    (untraced seconds, the trace's events, the marked calls' summed
    bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        app.step()
    if cuda:
        torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    probe.profiling, probe.bound_s = True, 0.0
    try:
        with profile(activities=activities) as prof:
            with record_function(WINDOW_MARK):
                for _ in range(steps):
                    app.step()
                if cuda:
                    torch.cuda.synchronize()
    finally:
        probe.profiling = False
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return untraced_s, events, probe.bound_s


def run(cell, seed: int, steps: int, device, before: int = 0) -> dict:
    """Set ``cell`` up as a run does, step ``before`` times (a run's
    window, untimed), then :func:`profile_events` over ``steps`` steps:
    the result's dict."""
    from portbench import harness, trace
    cfg = cell.config
    probe = harness.Probe(device == "cuda")
    app = harness.app_module(cfg).App(cfg, cell.traffic, seed, device,
                                      probe, harness.session_settings(cell))
    try:
        app.setup()
        for _ in range(before):
            app.step()
        untraced_s, events, bound_s = profile_events(app, probe, steps)
    finally:
        app.close()
    prof = trace.summarize(events, bound_s)
    red = reduce(events)
    return {"workload": cell.name, "steps": steps, "untraced_s": untraced_s,
            "profile": None if prof is None else dataclasses.asdict(prof),
            "metrics": metrics(red, steps),
            "spans": ({} if red is None else
                      {k: dataclasses.asdict(v)
                       for k, v in sorted(red.spans.items())}),
            "call_children_s": {} if red is None else red.call_children_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=0,
                    help="traced steps (default: the cell's trace_steps)")
    ap.add_argument("--before", type=int, default=0,
                    help="steps run first, as a run's window runs them")
    args = ap.parse_args(argv)
    from portbench import harness, run as runner
    runner._caches()
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    out = run(cell, args.seed, args.steps or cell.config["trace_steps"],
              "cuda", args.before)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
