"""The traced steps: ``torch.profiler`` over a few steps after the window,
and the reduction of its trace to what the per-layer readers take.

The harness marks the traced steps with :data:`WINDOW_MARK` and each
application-level BLAS call with :data:`BLAS_MARK` (host annotations).
A call's kernel time is the device time of the kernels whose launches
(CUDA runtime or driver calls, CUDA graph launches included) the host
issued inside its mark, matched by the profiler's correlation ids;
copies and memsets are left out.  The device is busy wherever a kernel,
a copy or a memset runs; what is left of the window is idle, and each
idle gap is put down to the innermost host operation that was running
at its middle.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

WINDOW_MARK = "portbench.window"
BLAS_MARK = "portbench.blas"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: entries of each list of the breakdown
TOP = 10
#: characters kept of a kernel's name
NAME_CHARS = 96


@dataclasses.dataclass
class Profile:
    """What the traced steps say, in seconds."""

    window_s: float          # the traced window, host clock
    busy_s: float            # union of device activity inside it
    blas_kernel_s: float     # kernels launched inside the BLAS marks
    blas_bound_s: float      # the marked calls' bounds (portbench.counts)
    blas_calls: int          # BLAS marks seen
    device_ops: list         # [[name, seconds]], most time first
    idle_gaps: list          # [[host operation, seconds]], most first
    untraced_s: float = 0.0  # as many steps just before, no profiler


def _union(intervals: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _host_labels(host: List[dict], points: List[float]) -> List[str]:
    """The innermost host event that covers each of ``points`` (sorted):
    events of one thread nest, so a sweep with a stack finds it."""
    order = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    labels, stack, i = [], [], 0
    for p in points:
        while i < len(order) and order[i]["ts"] <= p:
            e = order[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < p:
            stack.pop()
        if not stack:
            labels.append("python")
        elif stack[-1]["cat"] in LAUNCH_CATS and len(stack) > 1:
            # a runtime call (a copy, a synchronize) inside its operator
            labels.append(f"{stack[-2]['name']} > {stack[-1]['name']}")
        else:
            labels.append(stack[-1]["name"])
    return labels


def summarize(events: List[dict], blas_bound_s: float) -> Optional[Profile]:
    """Reduce chrome-trace events to a :class:`Profile`; None where the
    trace holds no window mark or no device activity in it."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    window = next((e for e in marks if e["name"] == WINDOW_MARK), None)
    if window is None:
        return None
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    tid = window["tid"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in device
                   if e["ts"] < w1 and e["ts"] + e["dur"] > w0])
    busy_us = sum(b - a for a, b in busy)
    if busy_us <= 0:
        return None
    # kernels launched inside the BLAS marks, by correlation id
    blas = sorted((e["ts"], e["ts"] + e["dur"]) for e in marks
                  if e["name"] == BLAS_MARK and e["tid"] == tid
                  and w0 <= e["ts"] <= w1)
    starts = [a for a, _ in blas]
    corr = set()
    for e in events:
        if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] <= blas[i][1]:
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    corr.add(c)
    blas_us = sum(e["dur"] for e in device if e["cat"] == "kernel"
                  and e.get("args", {}).get("correlation") in corr)
    by_name: Dict[str, float] = {}
    for e in device:
        if e["ts"] < w1 and e["ts"] + e["dur"] > w0:
            name = _short(e["name"])
            by_name[name] = by_name.get(name, 0.0) + e["dur"] * 1e-6
    # idle gaps inside the window, put down to the host's innermost op
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host = [e for e in events if e.get("ph") == "X" and e.get("tid") == tid
            and e.get("cat") in HOST_CATS and e is not window]
    labels = _host_labels(host, [(a + b) / 2 for a, b in gaps])
    by_host: Dict[str, float] = {}
    for (a, b), label in zip(gaps, labels):
        by_host[label] = by_host.get(label, 0.0) + (b - a) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]
    return Profile(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                   blas_kernel_s=blas_us * 1e-6, blas_bound_s=blas_bound_s,
                   blas_calls=len(blas), device_ops=top(by_name),
                   idle_gaps=top(by_host))


def profile_steps(app, probe, steps: int) -> Optional[Profile]:
    """Time ``steps`` more steps of ``app`` on the host clock, then run
    as many under the profiler, with the BLAS marks on, and reduce the
    trace.  The untraced time is what the profiler's own cost (large
    where it traces each node of a replayed CUDA graph) leaves out.  The
    trace file goes to a temporary directory (``TMPDIR``) and is
    deleted."""
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
    prof = summarize(events, probe.bound_s)
    return (None if prof is None
            else dataclasses.replace(prof, untraced_s=untraced_s))
