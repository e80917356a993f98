"""Trace-replay autotuner: tune ``SCILIB_*`` knobs from a recorded workload.

The port's copy of ``repro/tools/autotune.py``, over the port's
simulator, trace and :class:`~repro_torch.core.config.OffloadConfig`.

The paper notes the optimal offload threshold is device- and
workload-dependent (§3.3) — there is no constant that is right for both a
reuse-heavy LSMS run and a movement-bound skinny-gemm stream.  This tool
closes the loop without touching application code, mirroring the paper
tool's no-recompile ethos:

1. record a trace from any run (``SCILIB_TRACE=/path.json``, dumped
   automatically at ``uninstall()``),
2. replay it through the memtier N-device DFU simulator across a
   threshold x policy x device-count x device-bytes-cap x
   eviction-policy grid,
3. print the grid, the recommended ``SCILIB_*`` settings, and the
   predicted time/moved-bytes deltas against the paper-default baseline.

Command line::

    python -m repro_torch.tools.autotune trace.json
    python -m repro_torch.tools.autotune trace.json --spec tpu-v5e \
        --policies dfu,memcopy --thresholds 300,500,1000 --devices 1,2,4 \
        --device-bytes auto --evict lru,lfu,refetch

The threshold grid defaults to
:func:`repro_torch.core.threshold.threshold_grid`
over the trace's observed N_avg values — only thresholds that flip at
least one call's decision are worth simulating.  The device-bytes grid
defaults to ``auto``: fractions of the uncapped replay's peak device
residency, because both the live runtime and the simulator now run the
same :class:`repro_torch.core.residency.ResidencyStore`, a capped replay's
eviction/refetch counts are directly comparable to a live capped run —
so the tool can recommend a *cap* (how much HBM the workload actually
needs), not just a threshold.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import threshold as thr
from repro_torch.core.trace import Trace
from repro_torch.memtier.simulator import MemTierSimulator, PolicyReport
from repro_torch.memtier.spec import SPECS, HardwareSpec

#: policies the grid sweeps by default; ``pinned`` is a capacity bracket,
#: not a deployable setting, and ``cpu`` is implied by a huge threshold.
DEFAULT_POLICIES = ("dfu", "memcopy", "counter")
DEFAULT_DEVICE_COUNTS = (1, 2, 4)
#: eviction policies swept at each capped point (lru alone is pointless
#: to sweep uncapped: no cap, no eviction, identical replay).
DEFAULT_EVICTS = ("lru", "lfu", "refetch")

#: the comparison point: the paper's conservative default configuration
#: (policy, threshold, n_devices, device_bytes cap, eviction policy,
#: kernel path, precision scheme, LAPACK block size).
BASELINE = ("dfu", thr.DEFAULT_THRESHOLD, 1, None, "lru", False, "", 0)

#: LU block sizes swept when the trace carries solver spans (0 = as
#: recorded, i.e. whatever ``nb`` the run factored with).
DEFAULT_LAPACK_NBS = (0, 64, 128, 256)


def _fmt_threshold(t: float) -> str:
    return str(int(t)) if float(t).is_integer() else f"{t:.1f}"


def _fmt_cap(cap: Optional[int]) -> str:
    if cap is None:
        return "-"
    if cap >= 1 << 30:
        return f"{cap / (1 << 30):.1f}G"
    return f"{cap / (1 << 20):.0f}M"


@dataclasses.dataclass
class GridPoint:
    """One simulated (policy, threshold, n_devices, cap, evict, kernel,
    precision, lapack_nb) config."""

    policy: str
    threshold: float
    n_devices: int
    report: PolicyReport
    device_bytes: Optional[int] = None
    evict: str = "lru"
    kernel: bool = False    # SCILIB_KERNELS: the pallas dispatch venue
    precision: str = ""     # SCILIB_PRECISION: the split-emulation scheme
    lapack_nb: int = 0      # SCILIB_LAPACK_NB: LU block size (0 = as run)

    @property
    def config(self) -> Tuple:
        return (self.policy, self.threshold, self.n_devices,
                self.device_bytes, self.evict, self.kernel,
                self.precision, self.lapack_nb)

    @property
    def total_s(self) -> float:
        return self.report.total_s

    @property
    def moved_bytes(self) -> int:
        return self.report.moved_bytes

    def env(self) -> Dict[str, str]:
        """The ``SCILIB_*`` settings that realize this point."""
        settings = {"SCILIB_POLICY": self.policy,
                    "SCILIB_THRESHOLD": _fmt_threshold(self.threshold)}
        if self.n_devices > 1:
            settings["SCILIB_DEVICES"] = str(self.n_devices)
        if self.device_bytes is not None:
            settings["SCILIB_DEVICE_BYTES"] = str(self.device_bytes)
        if self.evict != "lru":
            settings["SCILIB_EVICT"] = self.evict
        if self.kernel:
            settings["SCILIB_KERNELS"] = "1"
        if self.precision:
            settings["SCILIB_PRECISION"] = self.precision
        if self.lapack_nb:
            settings["SCILIB_LAPACK"] = "1"
            settings["SCILIB_LAPACK_NB"] = str(self.lapack_nb)
        return settings

    def to_config(self):
        """The typed :class:`~repro_torch.core.config.OffloadConfig` that
        realizes this point — what ``--emit-config`` writes, and what
        ``repro_torch.session(OffloadConfig.load(...))`` runs directly.
        ``devices`` is always explicit (``None`` would re-resolve to
        the deploy host's device count, which is not what was tuned)."""
        from repro_torch.core.config import OffloadConfig
        return OffloadConfig(
            policy=self.policy, threshold=self.threshold,
            devices=self.n_devices,
            device_bytes=self.device_bytes, evict=self.evict,
            kernel_path=self.kernel, precision=self.precision,
            lapack=bool(self.lapack_nb), lapack_nb=self.lapack_nb)


@dataclasses.dataclass
class AutotuneResult:
    """Everything :func:`autotune` learned from one trace."""

    points: List[GridPoint]
    baseline: GridPoint
    best: GridPoint

    @property
    def speedup(self) -> float:
        return self.baseline.total_s / max(1e-12, self.best.total_s)

    @property
    def moved_delta(self) -> int:
        """Moved-byte change of the recommendation (negative = less)."""
        return self.best.moved_bytes - self.baseline.moved_bytes

    def recommended_cap(self) -> Optional[GridPoint]:
        """The tightest swept ``SCILIB_DEVICE_BYTES`` that keeps the
        best configuration within 2% of its uncapped predicted time —
        how much device residency this workload actually needs.  None
        when no capped point stays near (or none was swept)."""
        twin = [p for p in self.points
                if p.device_bytes is not None
                and (p.policy, p.threshold, p.n_devices, p.kernel,
                     p.precision, p.lapack_nb) ==
                    (self.best.policy, self.best.threshold,
                     self.best.n_devices, self.best.kernel,
                     self.best.precision, self.best.lapack_nb)
                and p.total_s <= self.best.total_s * 1.02]
        if not twin:
            return None
        return min(twin, key=lambda p: (p.device_bytes, p.total_s))


def _simulate(trace: Trace, spec: HardwareSpec, policy: str,
              threshold: float, n_devices: int,
              device_bytes: Optional[int] = None,
              evict: str = "lru", kernel: bool = False,
              precision: str = "", lapack_nb: int = 0) -> GridPoint:
    # lapack_nb is a label only: the caller hands in the already-retiled
    # trace (retile_lapack), the simulator itself is nb-oblivious.
    sim = MemTierSimulator(spec, policy=policy, threshold=threshold,
                           n_devices=n_devices, device_bytes=device_bytes,
                           evict=evict, kernel_path=kernel,
                           precision=precision)
    return GridPoint(policy, threshold, n_devices, sim.run(trace),
                     device_bytes, evict, kernel, precision, lapack_nb)


def _is_lu_span(call) -> bool:
    return bool(call.solver_id) and call.solver in ("getrf", "gesv")


def retile_lapack(trace: Trace, nb: int) -> Trace:
    """Re-tile the trace's LU solver spans at block size ``nb``.

    The blocked-LU call structure is fully determined by (n, nb): per
    block a ``getf2`` panel, a ``trsm`` row-swap/solve of the panel's
    U12, and the trailing ``gemm`` — so a recorded span can be
    regenerated at any candidate ``nb`` without re-running the solver.
    Factor-phase calls of each ``getrf``/``gesv`` span are replaced by
    the re-tiled stream against the same factor buffer (preserving the
    cross-span buffer reuse DFU feeds on); solve-phase trsms (their
    ``m`` equals the matrix order — the factor trsms' ``m`` is the
    block size) are nb-independent and copied through, as are
    ``getrs``-only spans, non-solver calls, buffers and events.
    ``nb == 0`` (or a span-free trace) returns the trace unchanged.
    """
    if not nb:
        return trace
    lu_spans: Dict[str, List] = {}
    for c in trace:
        if _is_lu_span(c):
            lu_spans.setdefault(c.solver_id, []).append(c)
    if not lu_spans:
        return trace
    out = Trace()
    out.buffer_sizes = dict(trace.buffer_sizes)
    out.buffer_names = dict(trace.buffer_names)
    out._next_buf = trace._next_buf
    out.events = list(trace.events)
    emitted = set()
    for c in trace:
        sid = c.solver_id
        if sid not in lu_spans:
            out.calls.append(c)
            continue
        if sid in emitted:
            continue
        emitted.add(sid)
        span = lu_spans[sid]
        first = next(x for x in span if x.routine.endswith("getf2"))
        prec = first.routine[0]
        n = first.m                     # first panel spans all n rows
        fbuf = first.operands[0][1]
        for j0 in range(0, n, nb):
            jb = min(nb, n - j0)
            out.panel(prec, n - j0, jb, fbuf, solver=sid)
            rem = n - j0 - jb
            if rem > 0:
                out.trsm(prec, jb, rem, fbuf, fbuf, solver=sid)
                out.gemm(prec, rem, rem, jb, fbuf, fbuf, fbuf,
                         solver=sid)
        for x in span:
            if x.routine.endswith("trsm") and x.m == n:
                out.calls.append(x)     # getrs phase: nb-independent
    return out


def _cap_grid(device_bytes, baseline: GridPoint) -> List[Optional[int]]:
    """Resolve the device-bytes sweep.  ``"auto"`` derives candidates
    from the uncapped baseline replay's peak device residency — the only
    caps that change anything are the ones below what DFU would use."""
    if device_bytes is None:
        return [None]
    if device_bytes == "auto":
        peak = baseline.report.device_bytes_peak
        if not peak:
            return [None]
        return [None, peak // 2, peak // 4]
    caps: List[Optional[int]] = []
    for c in device_bytes:
        caps.append(None if not c else int(c))
    return caps or [None]


def autotune(trace: Trace, *, spec: HardwareSpec = SPECS["gh200"],
             policies: Sequence[str] = DEFAULT_POLICIES,
             thresholds: Optional[Sequence[float]] = None,
             device_counts: Sequence[int] = DEFAULT_DEVICE_COUNTS,
             device_bytes="auto",
             evicts: Sequence[str] = DEFAULT_EVICTS,
             kernels: Optional[Sequence[bool]] = None,
             precisions: Optional[Sequence[str]] = None,
             lapack_nbs: Optional[Sequence[int]] = None,
             ) -> AutotuneResult:
    """Sweep the grid and pick the fastest point (moved bytes break ties).

    Multi-device replay only exists for the ``dfu`` policy (the runtime's
    tile scheduler never shards the others), so non-dfu policies are
    swept at one device only.  Likewise the device-bytes cap and the
    eviction policy model the runtime's DFU residency store, so only
    ``dfu`` sweeps them (and eviction policies only matter under a cap).

    The kernel dimension (``SCILIB_KERNELS``) defaults to auto: it is
    swept only when the trace carries venue tags — a venue-free trace
    has no probe timings to calibrate the pallas cost model from, so
    both kernel settings would replay identically and the sweep would
    only double the grid.  Kernel-off points precede their kernel-on
    twins, so an exact tie recommends the simpler configuration.

    The precision dimension (``SCILIB_PRECISION``) is gated the same
    way: swept only when the trace carries split-scheme tags to
    calibrate the split/native cost ratio from, and — the recommendation
    guard — only when the recorded run's escalation rate stayed under
    10% of its split calls.  A workload whose residual checks keep
    escalating pays for the split passes *and* the native reruns; its
    trace is evidence the scheme does not fit, so the tuner refuses to
    recommend it.

    The LAPACK block-size dimension (``SCILIB_LAPACK_NB``) is gated on
    solver spans: only a trace whose LU factorizations were recorded
    through the solver tier (``SCILIB_LAPACK=1``) can be re-tiled —
    each candidate ``nb`` replays a :func:`retile_lapack` variant of
    the trace, trading panel count against trailing-gemm size.
    ``nb == 0`` (the baseline) replays the trace exactly as recorded.
    """
    if thresholds is None:
        thresholds = thr.threshold_grid(c.n_avg for c in trace)
    if kernels is None:
        kernels = ((False, True) if any(c.venue for c in trace)
                   else (False,))
    if precisions is None:
        schemes = sorted({c.precision for c in trace if c.precision})
        tagged = sum(1 for c in trace if c.precision)
        esc = trace.event_count("escalate")
        if schemes and esc <= 0.1 * tagged:
            precisions = ("",) + tuple(schemes)
        else:
            precisions = ("",)
    if lapack_nbs is None:
        lapack_nbs = (DEFAULT_LAPACK_NBS
                      if any(_is_lu_span(c) for c in trace) else (0,))
    retiled = {lnb: retile_lapack(trace, lnb) for lnb in set(lapack_nbs)}
    baseline = _simulate(trace, spec, *BASELINE)
    caps = _cap_grid(device_bytes, baseline)
    points: List[GridPoint] = [baseline]
    for policy in policies:
        for t in thresholds:
            for nd in device_counts:
                if nd > 1 and policy != "dfu":
                    continue
                for cap in (caps if policy == "dfu" else [None]):
                    for ev in (evicts if cap is not None else ["lru"]):
                        for kern in kernels:
                            for prc in precisions:
                                for lnb in lapack_nbs:
                                    cfg = (policy, float(t), nd, cap, ev,
                                           bool(kern), str(prc),
                                           int(lnb))
                                    if cfg == BASELINE:
                                        continue    # already simulated
                                    points.append(_simulate(
                                        retiled[lnb], spec, *cfg))
    # fastest first; among points within 2% of it, least movement wins —
    # a config that moves gigabytes for a sub-noise predicted gain is
    # not a recommendation.  Uncapped points precede capped twins in the
    # list, so an exact tie recommends the simpler configuration.
    fastest = min(p.total_s for p in points)
    near = [p for p in points if p.total_s <= fastest * 1.02]
    best = min(near, key=lambda p: (p.moved_bytes, p.total_s))
    return AutotuneResult(points=points, baseline=baseline, best=best)


# --------------------------------------------------------------------- #
# presentation                                                           #
# --------------------------------------------------------------------- #
def _grid_row(p: GridPoint, mark: str = "") -> str:
    return (f"{p.policy:<9}{_fmt_threshold(p.threshold):>10}"
            f"{p.n_devices:>6}{_fmt_cap(p.device_bytes):>8}"
            f"{p.evict:>9}{('on' if p.kernel else '-'):>6}"
            f"{(p.precision or '-'):>8}"
            f"{(str(p.lapack_nb) if p.lapack_nb else '-'):>5}"
            f"{p.total_s:>10.4f}"
            f"{p.moved_bytes / 1e9:>10.3f}"
            f"{p.report.offloaded_calls:>9}"
            f"{p.report.evictions:>7}{mark}")


def format_grid(result: AutotuneResult, top: int = 12) -> str:
    lines = [f"{'policy':<9}{'threshold':>10}{'ndev':>6}{'cap':>8}"
             f"{'evict':>9}{'kern':>6}{'prec':>8}{'nb':>5}{'pred_s':>10}"
             f"{'moved_GB':>10}{'offload':>9}{'evict#':>7}"]
    ranked = sorted(result.points,
                    key=lambda p: (p.total_s, p.moved_bytes))[:top]
    for p in ranked:
        mark = " <- baseline" if p is result.baseline else (
            " <- best" if p is result.best else "")
        lines.append(_grid_row(p, mark))
    # the two rows the operator must be able to cross-check are always
    # shown, even when they rank below the top-N cut
    for p, mark in ((result.best, " <- best"),
                    (result.baseline, " <- baseline")):
        if p not in ranked:
            lines.append(_grid_row(p, mark))
            ranked.append(p)
    return "\n".join(lines)


def format_sites(trace: Trace, result: AutotuneResult,
                 top: int = 6) -> str:
    """Per-site baseline vs recommended predicted seconds (needs a trace
    recorded after call-site identity existed; silent otherwise)."""
    flops: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for c in trace:
        if not c.callsite_id:
            continue
        flops[c.callsite_id] = flops.get(c.callsite_id, 0.0) + c.flops
        calls[c.callsite_id] = calls.get(c.callsite_id, 0) + 1
    if not flops:
        return ""
    base_s = result.baseline.report.per_site_s
    best_s = result.best.report.per_site_s
    lines = ["call sites (predicted seconds, baseline -> recommended)",
             f"{'site':<44}{'calls':>7}{'GFLOP':>9}{'base_s':>9}"
             f"{'best_s':>9}"]
    for site in sorted(flops, key=lambda s: -flops[s])[:top]:
        label = site if len(site) <= 43 else site[:40] + "..."
        lines.append(f"{label:<44}{calls[site]:>7}"
                     f"{flops[site] / 1e9:>9.2f}"
                     f"{base_s.get(site, 0.0):>9.4f}"
                     f"{best_s.get(site, 0.0):>9.4f}")
    return "\n".join(lines)


def format_recommendation(result: AutotuneResult) -> str:
    env = " ".join(f"{k}={v}" for k, v in result.best.env().items())
    if result.baseline.moved_bytes > 0:
        delta = (f"({100.0 * result.moved_delta / result.baseline.moved_bytes:+.0f}%)")
    else:
        delta = f"({result.moved_delta / 1e9:+.3f} GB)"
    lines = [
        f"baseline  (dfu @ {_fmt_threshold(result.baseline.threshold)}, "
        f"1 device): {result.baseline.total_s:.4f} s predicted, "
        f"{result.baseline.moved_bytes / 1e9:.3f} GB moved",
        f"recommended: {env}",
        f"  predicted {result.best.total_s:.4f} s "
        f"({result.speedup:.2f}x vs baseline), "
        f"{result.best.moved_bytes / 1e9:.3f} GB moved {delta}",
    ]
    cap = result.recommended_cap()
    if cap is not None:
        lines.append(
            f"  cap: SCILIB_DEVICE_BYTES={cap.device_bytes} "
            f"(SCILIB_EVICT={cap.evict}) stays within 2% — "
            f"{cap.report.evictions} evictions, "
            f"{cap.report.refetched_bytes / 1e9:.3f} GB refetched; "
            f"the workload needs no more device memory than this")
    if result.best is result.baseline:
        lines.append("  the default configuration is already optimal "
                     "for this workload")
    return "\n".join(lines)


# --------------------------------------------------------------------- #
# CLI                                                                    #
# --------------------------------------------------------------------- #
def _parse_floats(raw: str) -> Tuple[float, ...]:
    return tuple(float(v) for v in raw.split(",") if v)


def _parse_ints(raw: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in raw.split(",") if v)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.autotune",
        description="Replay a recorded BLAS trace across a threshold x "
                    "policy x device grid and recommend SCILIB_* settings.")
    ap.add_argument("trace", help="trace JSON (SCILIB_TRACE=... dump)")
    ap.add_argument("--spec", default="gh200", choices=sorted(SPECS),
                    help="hardware spec to simulate (default: gh200)")
    ap.add_argument("--policies", default=",".join(DEFAULT_POLICIES),
                    help="comma list of policies to sweep")
    ap.add_argument("--thresholds", default="",
                    help="comma list of thresholds (default: derived "
                         "from the trace's N_avg distribution)")
    ap.add_argument("--devices", default=",".join(
        str(d) for d in DEFAULT_DEVICE_COUNTS),
        help="comma list of device counts (dfu only beyond 1)")
    ap.add_argument("--device-bytes", default="auto",
                    help="comma list of SCILIB_DEVICE_BYTES caps to "
                         "sweep (0 = uncapped), or 'auto' to derive "
                         "fractions of the uncapped replay's peak "
                         "device residency (dfu only)")
    ap.add_argument("--evict", default=",".join(DEFAULT_EVICTS),
                    help="comma list of eviction policies to sweep at "
                         "each capped point (lru, lfu, refetch)")
    ap.add_argument("--kernels", default="auto",
                    choices=("auto", "off", "on", "both"),
                    help="sweep the SCILIB_KERNELS (pallas venue) "
                         "dimension; 'auto' sweeps it only when the "
                         "trace carries venue tags to calibrate from")
    ap.add_argument("--precision", default="auto",
                    help="sweep the SCILIB_PRECISION (split-emulation) "
                         "dimension: 'auto' sweeps the schemes the "
                         "trace was recorded under (refused when its "
                         "escalation rate exceeded 10%%), 'off' pins "
                         "native, or a comma list of schemes (e.g. "
                         "split2,split3)")
    ap.add_argument("--lapack-nb", default="auto",
                    help="sweep the SCILIB_LAPACK_NB (LU block size) "
                         "dimension: 'auto' sweeps "
                         f"{','.join(str(v) for v in DEFAULT_LAPACK_NBS if v)} "
                         "when the trace carries solver spans, 'off' "
                         "pins the recorded tiling, or a comma list of "
                         "block sizes (0 = as recorded)")
    ap.add_argument("--top", type=int, default=12,
                    help="grid rows to print")
    ap.add_argument("--emit-config", metavar="PATH", default="",
                    help="write the recommendation as a typed "
                         "OffloadConfig JSON file: the tune->deploy "
                         "artifact repro_torch.session(OffloadConfig.load("
                         "PATH)) runs directly")
    args = ap.parse_args(argv)

    trace = Trace.load(args.trace)
    thresholds = _parse_floats(args.thresholds) or None
    device_bytes = (args.device_bytes if args.device_bytes == "auto"
                    else _parse_ints(args.device_bytes))
    kernels = {"auto": None, "off": (False,), "on": (True,),
               "both": (False, True)}[args.kernels]
    if args.precision == "auto":
        precisions = None
    elif args.precision == "off":
        precisions = ("",)
    else:
        precisions = ("",) + tuple(
            p for p in args.precision.split(",") if p and p != "native")
    if args.lapack_nb == "auto":
        lapack_nbs = None
    elif args.lapack_nb == "off":
        lapack_nbs = (0,)
    else:
        lapack_nbs = (0,) + tuple(
            v for v in _parse_ints(args.lapack_nb) if v)
    result = autotune(trace, spec=SPECS[args.spec],
                      policies=tuple(args.policies.split(",")),
                      thresholds=thresholds,
                      device_counts=_parse_ints(args.devices),
                      device_bytes=device_bytes,
                      evicts=tuple(args.evict.split(",")),
                      kernels=kernels, precisions=precisions,
                      lapack_nbs=lapack_nbs)
    n_sites = len({c.callsite_id for c in trace if c.callsite_id})
    print(f"autotune: {len(result.points)}-point grid, spec={args.spec}, "
          f"{len(trace)} calls, {n_sites} sites, "
          f"{trace.total_flops / 1e9:.2f} GFLOP")
    print(format_grid(result, top=args.top))
    sites = format_sites(trace, result)
    if sites:
        print(sites)
    print(format_recommendation(result))
    if args.emit_config:
        result.best.to_config().save(args.emit_config)
        print(f"config written to {args.emit_config} — run it with "
              f"repro_torch.session(OffloadConfig.load({args.emit_config!r}))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
