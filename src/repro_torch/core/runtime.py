"""The offload runtime: placement, dispatch and statistics (paper §3).

The port's counterpart of ``repro/core/runtime.py``.  An
:class:`OffloadRuntime` is configured by one
:class:`~repro_torch.core.config.OffloadConfig`, runs on one
``torch.device`` (the card, or the CPU in simulated-tier mode), normally
lives inside a :class:`~repro_torch.core.session.Session`, and owns

* the **placement registry** — buffer identity -> device-tier placement,
  the analogue of the remapped page table of the paper's Fig. 2.  It is
  a byte-capped :class:`~repro_torch.core.residency.ResidencyStore`
  (``device_bytes``, ``evict``, ``pin``) whose place/hit/evict/refetch
  transitions are recorded into the trace,
* the **offload decision** (the N_avg threshold of §3.3), memoized per
  call shape in the **dispatch cache**,
* the **statistics** the paper's ``.fini_array`` hook prints,
* a **BLAS trace** in the reference schema, so a run replays through the
  reference memtier simulator,
* the **multi-device tile scheduler**: with more than one device tier
  (``OffloadConfig.devices``), super-threshold calls split into 2-D
  tiles dealt round-robin with affinity across the tiers, BLASX-style —
  a tile runs on the tier where its operand blocks already are, tracked
  in one block store per tier with its own byte cap and eviction
  counters.  With one card the tiers share its memory and differ only in
  their accounting (:func:`repro_torch.core.memspace.put_block`); with
  one tier the scheduler is inert,
* the **fault guard**: every operand movement and every kernel (or tile)
  is a guarded unit (:meth:`OffloadRuntime._guarded`) — injected faults
  fire at its entry, transient faults retry with backoff, exhaustion or
  a permanent fault falls back to the host path with the same operands,
  and a per-tier circuit breaker quarantines a tier that keeps failing
  (:mod:`repro_torch.core.faults`, which also lists the errors the guard
  never absorbs on the card),
* its tenancy in a :class:`~repro_torch.core.residency.SharedDevicePool`
  when its session joins one: the placement and block stores charge the
  pool's per-tenant ledger, and other tenants' pressure evicts from them.

**The dispatch pipeline.**  :meth:`OffloadRuntime.blas_call` runs

    canonicalize -> decide -> plan -> execute -> record

* *canonicalize* bundles the call into a :class:`CallContext` and
  fingerprints the call site (:mod:`repro_torch.core.callsite`);
* *decide* runs the ordered ``decision_stages`` — adaptive per-site
  lock-in (``adaptive``), the memoized dispatch cache, then the
  threshold rule — and the policy may veto offload; with every tier
  quarantined the call is served from the host (degraded mode); then the
  precision stage picks a split scheme (``precision``) and the venue
  stage the execution venue (``kernel_path``);
* *plan* asks the call's tile builder for a :class:`TilePlan` when the
  call offloads and more than one usable tier exists;
* *execute* runs the host path, the sharded tiles, or the whole-call
  offload path: the policy places every operand, and the arithmetic runs
  through ``kernels/ops.py`` on the placed tensors (the generic ``xla``
  closure, the ``pallas`` venue's kernel closure, or the split
  formulation); a split result is checked by a sampled residual and
  escalates to native fp64 when it misses ``precision_rtol``;
* *record* updates the per-routine and per-site statistics and appends a
  :class:`~repro_torch.core.trace.BlasCall` to the trace.

On the card every call of the gemm family computes on CUDA tensors,
whichever path it took: an operand a policy left on the host is streamed
to the card for the call and counted in ``transient_bytes`` (the
coherent remote read of the GH200, made explicit), as the reference's
``_harmonize`` does on a backend with real memory tiers.  The host path
therefore needs room on the card too: when the card cannot hold even the
streamed operands, its ``torch.cuda.OutOfMemoryError`` propagates.

**Asynchronous by default.**  A call returns once its work is queued on
the card; the runtime records a CUDA event per call and
:meth:`OffloadRuntime.sync` waits on them.  ``sync=True`` synchronizes
after every call instead, so per-call times are device times.  Adaptive
warmup probes are always timed that way: the card is drained before the
probe starts and synchronized before its clock stops, so a probe bills
its device work and not its launch latency.  A kernel's own device fault
therefore surfaces at a later synchronization, not inside its guarded
unit; the guard sees what the launch and the allocations raise.

**Adaptive per-site mode** (``adaptive``): the first ``adaptive_warmup``
calls at each site rotate over the venues (host, xla and, with
``kernel_path`` and a kernel for the routine, pallas; plus the split
pseudo-venue with a ``precision`` scheme), timed, and the venue with the
best sample is then locked — the paper's warmup-then-patch behaviour.

**LAPACK-tier solver spans** (``lapack``, driven by
:mod:`repro_torch.solvers`): :meth:`OffloadRuntime.solver_begin` opens a
span that pins the factor buffer on the device tier, every BLAS call
recorded while it is the innermost span is stamped with its
``solver_id``, panels are recorded by :meth:`OffloadRuntime.note_panel`,
and :meth:`OffloadRuntime.solver_end` folds the span's time and movement
into :class:`SolverStats`.

**Threads.**  The whole pipeline runs under the runtime lock, so several
threads adopting one session (``Session.scope``) issue calls atomically.
Lock order: runtime -> health -> store -> pool, with the stats lock a
leaf.  Every worker launches on the current (default) stream.

The kernel block-edge override (``kernel_block``) picks a tile edge the
gemm kernel compiles (``kernels/gemm.py:EDGES``); another value is
refused (:func:`check_config`).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from contextvars import ContextVar
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from repro_torch.core import callsite as cs
from repro_torch.core import faults as flt
from repro_torch.core import memspace
from repro_torch.core import policy as pol
from repro_torch.core import precision as prec
from repro_torch.core import residency as res
from repro_torch.core import spans
from repro_torch.core import threshold as thr
from repro_torch.core.config import OffloadConfig
from repro_torch.core.trace import BlasCall, Trace

#: how many in-flight calls the async mode tracks for ``sync()``; the
#: card runs one stream in submission order, so a bounded window fences
#: everything submitted before it.
_PENDING_WINDOW = 32

#: dispatch-decision entries kept per runtime before a full reset
#: (long-lived servers over ragged shapes must not leak decisions).
_DECISION_CACHE_LIMIT = 65536


def check_config(config: OffloadConfig) -> None:
    """Raise ``ValueError`` for a ``kernel_block`` the gemm kernel does
    not compile."""
    from repro_torch.kernels import gemm
    if config.kernel_block and config.kernel_block not in gemm.EDGES:
        raise ValueError(f"OffloadConfig.kernel_block={config.kernel_block}"
                         f" is not a tile edge the gemm kernel compiles: "
                         f"0 (each path's default) or one of {gemm.EDGES}")


# --------------------------------------------------------------------- #
# re-entrancy guard: a call inside the pipeline is never intercepted     #
# --------------------------------------------------------------------- #
_TLS = threading.local()


def dispatching() -> bool:
    """True while this thread is inside :meth:`OffloadRuntime.blas_call`;
    the interceptors pass such calls straight to the originals."""
    return getattr(_TLS, "depth", 0) > 0


# --------------------------------------------------------------------- #
# tile plans (built by core.blas, executed by the scheduler below)       #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class TileOp:
    """One operand block of one tile.

    ``coords`` is the (r0, r1, c0, c1) window on the *parent* tensor —
    the stable block identity the affinity registry keys on, so the same
    window of the same tensor lands on the same tier call after call.
    ``shared`` marks blocks identical across every tile of the plan
    (e.g. the triangle of trsm): they replicate per tier and must not
    steer affinity, or every tile would chase one tier.
    """

    role: str
    parent: torch.Tensor
    coords: Tuple[int, int, int, int]
    shared: bool = False
    written: bool = False

    def key(self) -> Tuple:
        return (id(self.parent),) + self.coords

    @property
    def nbytes(self) -> int:
        r0, r1, c0, c1 = self.coords
        return (r1 - r0) * (c1 - c0) * self.parent.element_size()

    def materialize(self) -> torch.Tensor:
        r0, r1, c0, c1 = self.coords
        if (r0, c0) == (0, 0) and (r1, c1) == tuple(self.parent.shape[-2:]):
            return self.parent
        return self.parent[r0:r1, c0:c1]


@dataclasses.dataclass
class Tile:
    """One unit of scheduled work: placed operand blocks -> output block."""

    ops: Tuple[TileOp, ...]
    compute: Callable[..., torch.Tensor]
    out_coords: Tuple[int, int, int, int]


@dataclasses.dataclass
class TilePlan:
    """A 2-D decomposition of one level-3 call plus its gather."""

    grid: Tuple[int, int]
    tiles: Tuple[Tile, ...]
    gather: Callable[[Sequence[torch.Tensor]], torch.Tensor]


# --------------------------------------------------------------------- #
# dispatch-pipeline IR                                                   #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class CallContext:
    """One canonicalized BLAS call flowing through the pipeline."""

    routine: str
    m: int
    n: int
    k: int
    batch: int
    operands: Sequence[Tuple[str, torch.Tensor, float, bool]]
    arrays: list
    compute: Callable[..., torch.Tensor]
    key: Optional[Hashable]
    # tile-plan builder ``(n_devices, venue=, precision=) -> TilePlan``;
    # None when the call cannot shard (one tier, a batched call)
    shard: Optional[Callable[..., Optional[TilePlan]]] = None
    # the pallas-venue arithmetic (same operand order as ``compute``);
    # None when the routine has no kernel or kernel_path is off
    kernel_compute: Optional[Callable[..., torch.Tensor]] = None
    # split-precision factory ``(scheme, venue) -> compute``; None when
    # the call has no split formulation or no scheme is configured
    split_compute: Optional[Callable[[str, str],
                                     Callable[..., torch.Tensor]]] = None
    # sampled-residual estimator ``(out, *arrays) -> rel error`` for the
    # escalation check; None disables the check
    split_check: Optional[Callable[..., float]] = None
    # the operands the arithmetic ran on (placed on the device tier);
    # the residual check reads these, never tensors of another tier
    placed: Optional[list] = None
    site: Optional[cs.CallSiteProfile] = None
    site_id: str = ""
    # whether a profiler records the call's spans (read once a call: a
    # span's ``with`` costs more than this flag where nothing records)
    traced: bool = False


@dataclasses.dataclass
class DispatchDecision:
    """What a decision stage emits: offload?  why?  where?  how?"""

    offload: bool
    n_avg: float = 0.0
    why: str = "threshold"      # "cache" | "threshold" | "adaptive:probe"
    #                           # | "adaptive:locked" | "policy:host-only"
    #                           # | "fallback:<kind>" after a device fault
    #                           # (+ "+kernel" on the pallas venue,
    #                           # + "+<scheme>" / "+esc" for split calls)
    plan: Optional[TilePlan] = None
    timed: bool = False         # adaptive probe: drain, time, synchronize
    # execution venue ("host"/"xla"/"pallas"); "" with kernel_path off,
    # so the default pipeline is byte-identical to the two-venue one
    venue: str = ""
    # split-precision scheme ("split2"/"split3"); "" with precision off.
    # An escalated call keeps the attempted scheme (why gains "+esc").
    precision: str = ""


@dataclasses.dataclass
class RoutineStats:
    calls: int = 0
    offloaded: int = 0
    on_host: int = 0
    seconds: float = 0.0
    bytes_in: int = 0
    bytes_out: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    # dispatch fast path: calls whose offload decision came from the
    # dispatch cache vs. calls that had to derive it
    dispatch_hits: int = 0
    dispatch_misses: int = 0
    # bytes streamed from the host tier for one call without persisting
    transient_bytes: int = 0
    # multi-device tile scheduler: calls split across tiers / tiles run
    sharded: int = 0
    tiles: int = 0
    # failure paths: transient-fault retries and host fallbacks after
    # retry exhaustion or a permanent fault (the call still completed)
    retries: int = 0
    fallbacks: int = 0
    # kernel_path: offloaded calls executed on the pallas venue (a
    # subset of ``offloaded``) and their wall time
    kernel_calls: int = 0
    kernel_seconds: float = 0.0
    # split precision: offloaded calls executed via a split scheme
    # (subset of ``offloaded``), their wall time, and calls whose
    # residual check escalated back to native fp64
    split_calls: int = 0
    split_seconds: float = 0.0
    escalations: int = 0


@dataclasses.dataclass
class DeviceStats:
    """Per-device-tier accounting of the multi-device tile scheduler."""

    tiles: int = 0               # tile kernels scheduled on this tier
    moved_bytes: int = 0         # block movement onto this tier
    affinity_hits: int = 0       # blocks already resident here (free)
    evictions: int = 0           # per-tier byte-cap pressure
    evicted_bytes: int = 0


@dataclasses.dataclass
class SolverStats:
    """Per-solver accounting of the LAPACK tier (:mod:`repro_torch.solvers`):
    one row per solver name, aggregated over that solver's spans."""

    spans: int = 0               # solver_begin/solver_end pairs
    calls: int = 0               # inner BLAS + panel calls in the spans
    panel_calls: int = 0         # unblocked getf2 panels
    moved_bytes: int = 0         # movement attributed to the spans
    seconds: float = 0.0         # wall time inside the spans


@dataclasses.dataclass
class RuntimeStats:
    per_routine: Dict[str, RoutineStats] = dataclasses.field(
        default_factory=dict)
    per_device: Dict[int, DeviceStats] = dataclasses.field(
        default_factory=dict)
    # LAPACK-tier solver spans keyed by solver name: empty (and absent
    # from the report) unless repro_torch.solvers ran
    solvers: Dict[str, SolverStats] = dataclasses.field(
        default_factory=dict)
    uninstrumented_calls: int = 0
    # placement-registry cap pressure (mirrors the residency store)
    evictions: int = 0
    evicted_bytes: int = 0
    # evicted entries placed again later: the cap's real cost in traffic
    refetches: int = 0
    refetched_bytes: int = 0
    # failure-path counters (each increments exactly when the matching
    # trace event is emitted, so a live run and its replay agree)
    faults: int = 0            # fault errors observed (injected + real)
    retries: int = 0           # transient-fault retries performed
    fallbacks: int = 0         # calls completed on host after a failure
    quarantines: int = 0       # breaker trips (incl. half-open re-trips)
    recoveries: int = 0        # quarantined tiers re-admitted
    # per-call-site profiles (shared with the owning runtime's registry)
    callsites: Optional[cs.CallSiteRegistry] = None
    # the owning runtime's per-tier circuit breaker (health section)
    breaker: Optional[flt.HealthTracker] = None

    def routine(self, name: str) -> RoutineStats:
        return self.per_routine.setdefault(name, RoutineStats())

    def solver(self, name: str) -> SolverStats:
        return self.solvers.setdefault(name, SolverStats())

    def device(self, index: int) -> DeviceStats:
        return self.per_device.setdefault(index, DeviceStats())

    @property
    def total_moved_bytes(self) -> int:
        return sum(r.bytes_in + r.bytes_out
                   for r in self.per_routine.values())

    def reuse_ratio(self) -> float:
        hits = sum(r.cache_hits for r in self.per_routine.values())
        miss = sum(r.cache_misses for r in self.per_routine.values())
        return hits / max(1, miss)

    def dispatch_hit_ratio(self) -> float:
        hits = sum(r.dispatch_hits for r in self.per_routine.values())
        total = hits + sum(r.dispatch_misses
                           for r in self.per_routine.values())
        return hits / max(1, total)

    def report(self) -> str:
        """The report of ``repro/core/runtime.py``, in the same layout."""
        lines = ["scilib-accel runtime report",
                 f"{'routine':<10}{'calls':>8}{'offload':>9}{'host':>7}"
                 f"{'sec':>10}{'GB moved':>10}{'reuse':>8}{'dhit':>7}"]
        for name, r in sorted(self.per_routine.items()):
            gb = (r.bytes_in + r.bytes_out) / 1e9
            reuse = r.cache_hits / max(1, r.cache_misses)
            dhit = r.dispatch_hits / max(1, r.dispatch_hits
                                         + r.dispatch_misses)
            lines.append(f"{name:<10}{r.calls:>8}{r.offloaded:>9}"
                         f"{r.on_host:>7}{r.seconds:>10.3f}{gb:>10.3f}"
                         f"{reuse:>8.1f}{dhit:>7.2f}")
        lines.append(f"uninstrumented calls: {self.uninstrumented_calls}")
        if self.evictions:
            lines.append(f"evictions: {self.evictions} "
                         f"({self.evicted_bytes / 1e9:.3f} GB)")
        if self.refetches:
            lines.append(f"refetches: {self.refetches} "
                         f"({self.refetched_bytes / 1e9:.3f} GB)")
        if self.per_device:
            lines.append(f"{'device':<10}{'tiles':>8}{'GB moved':>10}"
                         f"{'affinity':>10}{'evict':>7}")
            for dev, d in sorted(self.per_device.items()):
                lines.append(f"{'dev' + str(dev):<10}{d.tiles:>8}"
                             f"{d.moved_bytes / 1e9:>10.3f}"
                             f"{d.affinity_hits:>10}{d.evictions:>7}")
        routines = self.per_routine.values()
        kernel_calls = sum(r.kernel_calls for r in routines)
        if kernel_calls:
            # only once the pallas venue ran, so kernel_path-off reports
            # are byte-identical to before
            ksec = sum(r.kernel_seconds for r in routines)
            lines.append(f"pallas venue: {kernel_calls} calls "
                         f"({ksec:.3f} s)")
        split_calls = sum(r.split_calls for r in routines)
        if split_calls:
            # only once a split scheme ran (same rule)
            ssec = sum(r.split_seconds for r in routines)
            esc = sum(r.escalations for r in routines)
            lines.append(f"split precision: {split_calls} calls "
                         f"({ssec:.3f} s, {esc} escalations)")
        if self.solvers:
            # only once a LAPACK-tier span ran (same rule)
            lines.append("solvers (LAPACK tier)")
            lines.append(f"{'solver':<10}{'spans':>7}{'calls':>8}"
                         f"{'panel%':>8}{'GB moved':>10}{'sec':>9}")
            for name, sv in sorted(self.solvers.items()):
                pct = 100.0 * sv.panel_calls / max(1, sv.calls)
                lines.append(f"{name:<10}{sv.spans:>7}{sv.calls:>8}"
                             f"{pct:>8.0f}{sv.moved_bytes / 1e9:>10.3f}"
                             f"{sv.seconds:>9.3f}")
        fault_activity = (self.faults + self.retries + self.fallbacks
                          + self.quarantines + self.recoveries)
        if fault_activity:
            # only once failure paths ran (same rule)
            lines.append(f"health: faults={self.faults} "
                         f"retries={self.retries} "
                         f"fallbacks={self.fallbacks} "
                         f"quarantines={self.quarantines} "
                         f"recoveries={self.recoveries}")
            if self.breaker is not None:
                for d, h in enumerate(self.breaker.devices()):
                    lines.append(f"  dev{d}: {h.state} "
                                 f"consecutive={h.consecutive} "
                                 f"failures={h.failures} "
                                 f"quarantines={h.quarantines}")
        if self.callsites is not None and len(self.callsites):
            lines.append("call sites (top by flops; * = adaptive lock)")
            lines.append(f"{'site':<44}{'calls':>7}{'GFLOP':>9}"
                         f"{'decision':>10}{'hit%':>6}{'sec':>9}")
            for p in self.callsites.top_by_flops():
                site = (p.site if len(p.site) <= 43
                        else p.site[:40] + "...")
                lines.append(f"{site:<44}{p.calls:>7}"
                             f"{p.flops / 1e9:>9.2f}"
                             f"{p.decision_label():>10}"
                             f"{100 * p.hit_rate:>6.0f}{p.seconds:>9.3f}")
        return "\n".join(lines)


#: real-FLOP factors per base routine
_FLOP_FACTORS = {
    "gemm": lambda m, n, k: 2.0 * m * n * k,
    "gemv": lambda m, n, k: 2.0 * m * n,
    "trsm": lambda m, n, k: 1.0 * m * m * n,
    "trmm": lambda m, n, k: 1.0 * m * m * n,
    "syrk": lambda m, n, k: 1.0 * n * n * k,
    "herk": lambda m, n, k: 1.0 * n * n * k,
    "symm": lambda m, n, k: 2.0 * m * m * n,
    "hemm": lambda m, n, k: 2.0 * m * m * n,
    "syr2k": lambda m, n, k: 2.0 * n * n * k,
    "her2k": lambda m, n, k: 2.0 * n * n * k,
}


def _flops_of(routine: str, m: int, n: int, k: int, batch: int = 1) -> float:
    """Real-FLOP count, matching :attr:`BlasCall.flops`: complex
    multiply-adds cost 4x their real counterparts."""
    fn = _FLOP_FACTORS.get(thr.base_routine(routine))
    if fn is None:
        return 0.0
    mult = 4.0 if routine[:1] in ("c", "z") else 1.0
    return mult * batch * fn(m, n, k)


class SolverSpan:
    """A live LAPACK-tier solver span (``solver_begin`` ..
    ``solver_end``).  While it is the innermost open span, every BLAS
    call the runtime records is stamped with its ``span_id``
    (``"<solver>#<seq>"``).  ``factor`` stays pinned on the device tier
    for the span's lifetime; ``placed`` is its device-tier tensor, the
    one the driver computes on, so a host factor crosses the link once
    per span."""

    __slots__ = ("name", "span_id", "factor", "placed", "pinned", "t0",
                 "moved0")

    def __init__(self, name: str, span_id: str, factor, placed,
                 pinned: bool, t0: float, moved0: int):
        self.name = name
        self.span_id = span_id
        self.factor = factor
        self.placed = placed
        self.pinned = pinned
        self.t0 = t0
        self.moved0 = moved0

    def __repr__(self) -> str:
        return f"SolverSpan({self.span_id})"


class OffloadRuntime:
    """Placement + dispatch brain behind the intercepted BLAS surface."""

    def __init__(self, config: Optional[OffloadConfig] = None, *,
                 device=None, record_trace: bool = True,
                 session_id: str = "",
                 pool: Optional[res.SharedDevicePool] = None):
        config = OffloadConfig.from_env() if config is None else config
        check_config(config)
        self.config = config
        # the dispatch lock serializes whole calls; the stats lock is a
        # leaf guarding counters that eviction hooks also update (shared-
        # pool pressure reaches this runtime's stores from whichever
        # thread overflowed the pool)
        self._lock = threading.RLock()
        self._stats_lock = threading.Lock()
        self.device = memspace.resolve_device(device)
        # the device-tier count is topology, fixed for the runtime's life
        self.n_devices = config.resolved_devices(self.device)
        self.memspace = memspace.for_device(self.device, self.n_devices)
        self.policy: pol.PolicyBase = pol.make_policy(config.policy)
        self.threshold = config.resolved_threshold()
        self.stats = RuntimeStats()
        self.trace: Optional[Trace] = Trace() if record_trace else None
        self.debug = config.debug
        self.sync_mode = bool(config.sync)
        self.dispatch_cache_enabled = config.dispatch_cache
        self.callsite_enabled = config.callsite
        self.adaptive = config.adaptive
        self.adaptive_warmup = config.adaptive_warmup
        # the pallas execution venue: off by default so the two-venue
        # pipeline stays bit-identical
        self.kernel_path = bool(config.kernel_path)
        # the gemm kernel's tile edge on the pallas venue (0: default)
        self.kernel_block = int(config.kernel_block)
        # split-precision emulation: off by default (native fp64)
        self.precision = str(config.precision)
        self.precision_rtol = float(config.precision_rtol)
        self.callsites = cs.CallSiteRegistry()
        self.stats.callsites = self.callsites
        # ordered decision stages: the first to return a decision wins
        self.decision_stages = [self._stage_adaptive, self._stage_cached,
                                self._stage_threshold]
        from repro_torch.core import blas
        blas.refresh_cache_flag(config.dispatch_cache)
        self.device_bytes_cap: Optional[int] = config.device_bytes
        self.evict_policy = config.evict
        self.pin_all = config.pin
        # dispatch cache: call key -> (offload, n_avg)
        self._decisions: Dict[Hashable, Tuple[bool, float]] = {}
        # placement registry: buffer_key(src) -> policy.Resident
        self.placements = res.ResidencyStore(
            "placements", cap=self.device_bytes_cap,
            policy=self.evict_policy, pin_new=self.pin_all,
            on_evict=self._on_placement_evict, emit=self._emit_event)
        # multi-device tile scheduler: one block store per device tier,
        # block key -> (placed block, parent version), plus the round-
        # robin cursor for blocks with no residency anywhere
        self.block_stores = [
            res.ResidencyStore(
                f"dev{d}", cap=self.device_bytes_cap,
                policy=self.evict_policy, pin_new=self.pin_all,
                on_evict=self._block_evict_hook(d), emit=self._emit_event)
            for d in range(self.n_devices)]
        self._rr_cursor = 0
        # tiles assigned to each tier within the call being scheduled
        # (tie-breaker: replicated blocks score several tiers equally)
        self._sched_load: list = [0] * self.n_devices
        # fault tolerance: the deterministic injector, the transient-
        # fault retry policy, and the per-tier breaker whose trips
        # invalidate residency and steer the tile scheduler.  Transfer
        # faults inject inside memspace (the real movement sites); the
        # hook is installed by activate(), never here, so a merely
        # constructed runtime cannot clobber the active one's.
        self.faults = flt.FaultInjector.from_spec(config.faults)
        self.retry = flt.RetryPolicy(attempts=config.retries,
                                     backoff_ms=config.backoff_ms)
        self.health = flt.HealthTracker(
            self.n_devices, threshold=config.breaker,
            cooldown_ms=config.breaker_cooldown_ms,
            on_quarantine=self._on_quarantine,
            on_recover=self._on_recover)
        self.stats.breaker = self.health
        # async mode: CUDA events of recent calls, drained by sync()
        self._pending: "collections.deque[torch.cuda.Event]" = (
            collections.deque(maxlen=_PENDING_WINDOW))
        # trace-buffer ids: id(tensor) -> trace buffer id, living exactly
        # as long as the tensor (the reference's identity rule)
        self._trace_ids = res.ResidencyStore("traceids")
        self._reuse_by_buffer: Dict[int, int] = {}
        # LAPACK-tier solver spans: innermost-last stack of open spans;
        # the top span stamps every recorded BLAS call
        self._solver_stack: list = []
        self._solver_seq = 0
        # multi-tenancy: join the shared pool (quota from the config),
        # binding the placement and block stores to the tenant's ledger.
        # An unnamed pooled runtime gets an assigned tenant id; unpooled
        # unnamed runtimes keep "" (their trace events stay unstamped).
        self.pool = pool
        if pool is not None:
            self.session_id = pool.register(session_id,
                                            quota=config.pool_quota)
            pool.attach(self.session_id, self.placements,
                        *self.block_stores)
        else:
            self.session_id = session_id

    def detach_pool(self) -> None:
        """Leave the shared pool (session close): the tenant's usage is
        forgotten, its lifetime counters stay in the pool totals."""
        if self.pool is not None:
            self.pool.unregister(self.session_id)
            self.pool = None

    def release(self) -> None:
        """Drop every placement and tile block (session close).  The
        stores' hooks tie them to this runtime in reference cycles, so
        without this the card's copies would live until the cyclic
        garbage collector ran, not until the session closed."""
        for store in (self.placements, *self.block_stores):
            store.clear()

    # ------------------------------------------------------------------ #
    # safe mid-run reconfiguration (Session.reconfigure lands here)       #
    # ------------------------------------------------------------------ #
    def apply_config(self, new: OffloadConfig) -> None:
        """Apply a new (already validated) config to the live runtime:
        the dispatch cache is cleared, the policy, threshold and sync
        mode switch, and caps, eviction policy and pinning update on every
        residency store with an immediate sweep under a tightened cap.
        A policy / threshold / adaptive / kernel_path / precision change
        resets the adaptive per-site locks, and drops the probe samples
        that timed a path the change killed (``runtime.py:631-716`` of
        the reference).  A new fault spec gets a fresh injector; the
        breaker keeps its per-tier state.  The device-tier count is
        topology: changing it raises ``ValueError``."""
        check_config(new)
        with self._lock:
            if new.resolved_devices(self.device) != self.n_devices:
                raise ValueError(
                    f"devices cannot change on a live runtime "
                    f"({self.n_devices} -> "
                    f"{new.resolved_devices(self.device)}); open a new "
                    f"session")
            old, old_threshold = self.config, self.threshold
            self.config = new
            self.threshold = new.resolved_threshold()
            self.sync_mode = bool(new.sync)
            self.debug = new.debug
            self.dispatch_cache_enabled = new.dispatch_cache
            self.callsite_enabled = new.callsite
            self.adaptive = new.adaptive
            self.adaptive_warmup = new.adaptive_warmup
            from repro_torch.core import blas
            blas.refresh_cache_flag(new.dispatch_cache)
            self._decisions.clear()
            policy_changed = new.policy != old.policy
            if policy_changed:
                self.policy = pol.make_policy(new.policy)
            kernel_changed = new.kernel_path != old.kernel_path
            precision_changed = (new.precision != old.precision
                                 or new.precision_rtol != old.precision_rtol)
            if (policy_changed or self.threshold != old_threshold
                    or new.adaptive != old.adaptive or kernel_changed
                    or precision_changed):
                for prof in self.callsites:
                    prof.reset(samples=policy_changed,
                               kernel=policy_changed or kernel_changed,
                               split=policy_changed or precision_changed)
            self.kernel_path = bool(new.kernel_path)
            self.kernel_block = int(new.kernel_block)
            self.precision = str(new.precision)
            self.precision_rtol = float(new.precision_rtol)
            self.device_bytes_cap = new.device_bytes
            self.evict_policy = new.evict
            pin_changed = new.pin != self.pin_all
            self.pin_all = new.pin
            for store in (self.placements, *self.block_stores):
                store.cap = new.device_bytes
                store.policy = res.make_eviction_policy(new.evict)
                store.pin_new = new.pin
                if pin_changed:
                    # pin=True pins existing residents too; pin=False
                    # makes them evictable again, or a new cap could not
                    # be kept
                    for key in list(store.keys()):
                        (store.pin if new.pin else store.unpin)(key)
                store.evict_over_cap()
            self.faults = flt.FaultInjector.from_spec(new.faults)
            self.retry = flt.RetryPolicy(attempts=new.retries,
                                         backoff_ms=new.backoff_ms)
            self.health.reconfigure(threshold=new.breaker,
                                    cooldown_ms=new.breaker_cooldown_ms)
            if active() is self:
                memspace.set_fault_hook(self._transfer_fault_hook())
                memspace.set_debug(new.debug)

    # ------------------------------------------------------------------ #
    # the residency engine: event + eviction hooks, pinning               #
    # ------------------------------------------------------------------ #
    def _emit_event(self, kind: str, store: str, nbytes: int) -> None:
        """Mirror one residency transition (place/hit/evict/refetch), and
        through the same channel each fault-tolerance transition
        (fault/retry/fallback/quarantine/recover), into the trace and
        the refetch statistics."""
        if kind == "refetch":
            with self._stats_lock:
                self.stats.refetches += 1
                self.stats.refetched_bytes += nbytes
        if self.trace is not None:
            self.trace.record_event(kind, store, nbytes,
                                    session=self.session_id)

    def _on_placement_evict(self, key, placed: pol.Resident,
                            nbytes: int) -> None:
        """Cap pressure pushed a placement out: re-tag the buffer
        host-side so the next use re-migrates (and is counted again).
        On the card the device copy is released with the entry, once
        nothing else holds it."""
        arr = placed.array()
        if arr is not None:
            memspace.tag_host(arr)
        with self._stats_lock:
            self.stats.evictions += 1
            self.stats.evicted_bytes += nbytes
        if self.debug >= 1:
            print(f"[scilib] evict {nbytes} B "
                  f"(resident {self.placements.resident_bytes} B)")

    def _block_evict_hook(self, device: int):
        """Per-tier eviction callback for the tile-block stores."""
        def _on_evict(key, placed, nbytes, device=device, self=self):
            memspace.tag_host(placed[0])
            with self._stats_lock:
                dst = self.stats.device(device)
                dst.evictions += 1
                dst.evicted_bytes += nbytes
            if self.debug >= 1:
                print(f"[scilib] dev{device} evict block {nbytes} B "
                      f"(resident "
                      f"{self.block_stores[device].resident_bytes} B)")
        return _on_evict

    # ------------------------------------------------------------------ #
    # fault tolerance: guard, retry, fallback, per-tier breaker           #
    # ------------------------------------------------------------------ #
    def _transfer_fault_hook(self):
        """The injector's transfer check, as memspace's hook (None when
        injection is off)."""
        if self.faults is None:
            return None
        inj = self.faults

        def _hook(device, nbytes):
            inj.check("transfer", device=device, nbytes=nbytes)
        return _hook

    def _guarded(self, site: str, fn, *, device: int, nbytes: int,
                 st: RoutineStats):
        """Run one transfer or kernel *unit* under the fault guard.

        The unit is the smallest retryable operation (one operand or
        block movement, one kernel or tile): injection happens at its
        entry, before any state mutates, so a fault absorbed by a retry
        leaves every counter and residency structure as in an unfaulted
        run.  Transient faults retry with exponential backoff
        (``retries``, ``backoff_ms``); exhaustion or a permanent fault
        records one breaker failure against ``device`` and raises —
        :meth:`_execute` turns that into a host fallback.  Errors
        :func:`repro_torch.core.faults.classify` does not absorb (bugs,
        the port's build and launch errors, CUDA's sticky errors)
        propagate unwrapped and count nothing."""
        attempt = 0
        while True:
            try:
                if site == "kernel" and self.faults is not None:
                    self.faults.check("kernel", device=device,
                                      nbytes=nbytes)
                out = fn()
            except Exception as raw:
                retry = self._note_fault(site, raw, device=device,
                                         nbytes=nbytes, attempt=attempt,
                                         st=st)
                if retry is None:     # not a device fault
                    raise
                if retry:
                    self.retry.sleep(attempt)
                    attempt += 1
                    continue
                self.health.failure(device)
                flt.raise_typed(site, raw, device=device, nbytes=nbytes)
            else:
                self.health.ok(device)
                return out

    def _note_fault(self, site: str, raw: Exception, *, device: int,
                    nbytes: int, attempt: int,
                    st: RoutineStats) -> Optional[bool]:
        """Count one failed attempt of a guarded unit: None when ``raw``
        is not a device fault, else whether the unit retries (a transient
        fault with attempts left; the retry is counted here)."""
        err = flt.classify(site, raw, device=device, nbytes=nbytes)
        if err is None:
            return None
        self.stats.faults += 1
        self._emit_event("fault", f"{err.kind}@dev{device}", nbytes)
        if self.debug >= 1:
            print(f"[scilib] {site} fault on dev{device} "
                  f"(attempt {attempt}): {err}")
        if not (err.transient and attempt < self.retry.attempts):
            return False
        self.stats.retries += 1
        st.retries += 1
        self._emit_event("retry", f"{site}@dev{device}", nbytes)
        return True

    def _on_quarantine(self, device: int) -> None:
        """Breaker trip: invalidate everything resident on the tier
        (evict-style events — the next use re-places on a healthy tier)
        and record the transition.  The tile scheduler and the plan
        stage consult ``health.usable`` and re-shard around it."""
        self.stats.quarantines += 1
        invalidated = self.block_stores[device].evict_all()
        if device == 0:
            # the whole-call placement registry is homed on tier 0
            invalidated += self.placements.evict_all()
        self._emit_event("quarantine", f"dev{device}", 0)
        if self.debug >= 1:
            print(f"[scilib] dev{device} quarantined "
                  f"({invalidated} residents invalidated)")

    def _on_recover(self, device: int) -> None:
        """Half-open probe succeeded: the tier is healthy again."""
        self.stats.recoveries += 1
        self._emit_event("recover", f"dev{device}", 0)
        if self.debug >= 1:
            print(f"[scilib] dev{device} recovered")

    def device_usable(self, device: int) -> bool:
        """May the scheduler route work to this device tier now?"""
        return self.health.usable(device)

    def _whole_device(self) -> int:
        """Device-tier index the whole-call (unsharded) offload path is
        attributed to: tier 0, or the first usable tier when 0 is
        quarantined."""
        if self.n_devices == 1 or self.health.usable(0):
            return 0
        for d in range(1, self.n_devices):
            if self.health.usable(d):
                return d
        return 0

    def _fallback_host(self, call: CallContext,
                       decision: DispatchDecision, st: RoutineStats,
                       exc: flt.OffloadError) -> torch.Tensor:
        """Retry exhausted (or a permanent fault): run the call on the
        host path — the same closure on the same operand values, so the
        result equals an unoffloaded run bit for bit — and surface the
        decision as ``fallback:<kind>``."""
        decision.offload = False
        decision.plan = None
        decision.why = f"fallback:{exc.kind}"
        decision.precision = ""        # the host rerun is native fp64
        self.stats.fallbacks += 1
        st.fallbacks += 1
        st.on_host += 1
        dev = exc.device if exc.device is not None else 0
        self._emit_event("fallback", f"{exc.kind}@dev{dev}", exc.nbytes)
        if self.debug >= 1:
            print(f"[scilib] {call.routine} falling back to host: {exc}")
        return self._host_compute(call, st)

    def pin(self, x: torch.Tensor) -> torch.Tensor:
        """Pin a buffer on the device tier: place it now if needed and
        mark it never-evictable until :meth:`unpin` or the buffer dies.
        Returns the placed device-tier tensor.  Pinning is a user-level
        movement with no fallback path, so it opts out of injection."""
        with self._lock:
            key, placed, stale = pol.lookup(self, x)
            if placed is None:
                if memspace.tier_of(x) == memspace.DEVICE:
                    placed = x
                    pol.register(self, key, x)
                else:
                    placed = pol.move(self, x, key, stale, check=False)
                    pol.register(self, key, x, placed)
                self.alias_trace_id(x, placed)
            self.placements.pin(key)
            return placed

    def unpin(self, x: torch.Tensor) -> None:
        """Make a pinned buffer evictable again (it stays resident until
        cap pressure selects it)."""
        with self._lock:
            self.placements.unpin(memspace.buffer_key(x))

    def note_uninstrumented(self) -> None:
        """Count one BLAS-shaped call the interceptors saw but could not
        canonicalize."""
        with self._stats_lock:
            self.stats.uninstrumented_calls += 1

    def resident_bytes(self) -> int:
        return self.placements.resident_bytes

    # ------------------------------------------------------------------ #
    # LAPACK-tier solver spans (repro_torch.solvers drives these)         #
    # ------------------------------------------------------------------ #
    def solver_begin(self, name: str, factor=None) -> SolverSpan:
        """Open a solver span: emit the ``solver_begin`` trace event,
        pin the factor buffer for the span's lifetime (the factorization
        re-reads it in every inner BLAS call) and make the span the stamp
        of every BLAS call recorded until :meth:`solver_end`.  Under
        ``policy="cpu"`` nothing is pinned and ``placed`` is the factor
        itself."""
        with self._lock:
            span_id = f"{name}#{self._solver_seq}"
            self._solver_seq += 1
            nbytes = (memspace.nbytes(factor)
                      if isinstance(factor, torch.Tensor) else 0)
            placed, pinned = factor, False
            if (isinstance(factor, torch.Tensor)
                    and self.config.policy != "cpu"):
                placed = self.pin(factor)
                pinned = True
            self.stats.solver(name).spans += 1
            span = SolverSpan(name, span_id, factor, placed, pinned,
                              time.perf_counter(),
                              self.stats.total_moved_bytes)
            self._solver_stack.append(span)
            self._emit_event("solver_begin", span_id, nbytes)
            return span

    def solver_end(self, span: SolverSpan) -> None:
        """Close a solver span: unpin the factor (it stays resident until
        cap pressure selects it), fold the span's wall time and movement
        into the per-solver statistics, and emit the ``solver_end`` trace
        event.  Idempotent."""
        with self._lock:
            try:
                self._solver_stack.remove(span)
            except ValueError:
                return
            if span.pinned:
                self.unpin(span.factor)
            sv = self.stats.solver(span.name)
            sv.seconds += time.perf_counter() - span.t0
            sv.moved_bytes += max(
                0, self.stats.total_moved_bytes - span.moved0)
            self._emit_event("solver_end", span.span_id, 0)

    def note_panel(self, prec: str, m: int, nb: int,
                   panel: torch.Tensor) -> None:
        """Record one unblocked panel factorization (``getf2``).  Only
        inside a solver span: outside the LAPACK tier the drivers emit
        exactly the BLAS stream they always did."""
        with self._lock:
            if not self._solver_stack:
                return
            span = self._solver_stack[-1]
            sv = self.stats.solver(span.name)
            sv.calls += 1
            sv.panel_calls += 1
            st = self.stats.routine(f"{prec}getf2")
            st.calls += 1
            st.on_host += 1
            if self.trace is not None:
                bid = self._trace_id(panel, "P")
                self.trace.calls.append(BlasCall(
                    routine=f"{prec}getf2", m=m, n=nb, k=0,
                    operands=(("P", bid, m * nb * panel.element_size(),
                               float(nb), True),),
                    solver_id=span.span_id))

    # ------------------------------------------------------------------ #
    # multi-device block stores + tile scheduler                          #
    # ------------------------------------------------------------------ #
    def next_device(self) -> int:
        """Round-robin cursor for blocks with no residency anywhere.
        Quarantined tiers are skipped; with every tier quarantined the
        cursor value is returned anyway (callers only reach here when
        the degraded-mode check has already allowed offload)."""
        for _ in range(self.n_devices):
            dev = self._rr_cursor % self.n_devices
            self._rr_cursor += 1
            if self.health.usable(dev):
                return dev
        return dev

    def scheduled_load(self, device: int) -> int:
        """Tiles already assigned to a tier in the call being scheduled
        (the affinity tie-breaker)."""
        return self._sched_load[device]

    def device_resident_bytes(self, device: int) -> int:
        return self.block_stores[device].resident_bytes

    def _place_block(self, device: int, op: TileOp, st: RoutineStats
                     ) -> Tuple[torch.Tensor, int, bool]:
        """Materialize one operand block on one device tier.

        Returns (placed block, bytes moved, affinity hit).  Persistent
        policies (DFU/pinned) register the block so later calls find it
        resident, with the parent's version counter: a parent written in
        place since is placed afresh.  Mem-Copy stages fresh every call.
        The movement runs under the fault guard — a retried block put is
        a perfect no-op (cache hits return above and never see it)."""
        key = op.key()
        store = self.block_stores[device]
        persistent = self.policy.persistent
        version = memspace.version_of(op.parent)
        if persistent:
            ent = store.entry(key)
            if ent is not None and ent.payload[1] != version:
                store.drop(key)
            cached = store.get(key)
            if cached is not None:
                return cached[0], 0, True
        block = op.materialize()
        placed = self._guarded(
            "transfer", lambda: memspace.put_block(block, device),
            device=device, nbytes=op.nbytes, st=st)
        # a no-op put (the block already lives on this tier, e.g. a
        # chained output reused whole) moved nothing
        moved = 0 if placed is block else op.nbytes
        if persistent:
            store.put(key, (placed, version), memspace.nbytes(placed),
                      anchor=op.parent)
        return placed, moved, False

    def _sharded_call(self, st: RoutineStats, plan: TilePlan,
                      site: Optional[cs.CallSiteProfile] = None,
                      ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        """Execute one call as scheduled tiles and gather the output.

        Tier choice is the policy's (:meth:`PolicyBase.select_device`):
        affinity first — the tier already holding the most operand-block
        bytes — then round-robin.  Output blocks are registered on their
        tier so the next call slicing the gathered result at the same
        coordinates reuses them (the BLASX chained-call path)."""
        # phase 1: schedule every tile against the residency at call
        # entry, so blocks placed by the first tiles cannot pull the
        # rest onto one tier
        self._sched_load = [0] * self.n_devices
        devices = []
        for tile in plan.tiles:
            dev = self.policy.select_device(
                self, [(op.key(), op.nbytes, op.shared) for op in tile.ops])
            self._sched_load[dev] += 1
            devices.append(dev)
        # phase 2: place blocks and run the tile kernels
        outs = []
        for tile, dev in zip(plan.tiles, devices):
            dst = self.stats.device(dev)
            placed = []
            for op in tile.ops:
                arr, moved, hit = self._place_block(dev, op, st)
                st.bytes_in += moved
                dst.moved_bytes += moved
                st.cache_hits += int(hit)
                st.cache_misses += int(not hit)
                dst.affinity_hits += int(hit)
                if site is not None:
                    site.observe_residency(hit)
                placed.append(arr)
            outs.append(self._guarded(
                "kernel", lambda t=tile, p=placed: self._run_tile(t, p),
                device=dev, nbytes=0, st=st))
            dst.tiles += 1
        out = plan.gather([o if o.device == self.device
                           else o.to(self.device) for o in outs])
        if self.policy.persistent:
            version = memspace.version_of(out)
            for tile, dev, block in zip(plan.tiles, devices, outs):
                self.block_stores[dev].put(
                    (id(out),) + tile.out_coords, (block, version),
                    memspace.nbytes(block), anchor=out)
        if self.policy.copy_back:
            st.bytes_out += memspace.nbytes(out)
            out = memspace.put(out, memspace.HOST)
        else:
            memspace.tag_device(out)
        st.offloaded += 1
        st.sharded += 1
        st.tiles += len(plan.tiles)
        return out, tuple(devices)

    @staticmethod
    def _run_tile(tile: Tile, placed: list) -> torch.Tensor:
        """One tile's arithmetic, on the card its blocks live on (with
        several cards the launch must be issued from that card)."""
        home = placed[0].device
        if home.type == "cuda" and torch.cuda.device_count() > 1:
            with torch.cuda.device(home):
                return tile.compute(*placed)
        return tile.compute(*placed)

    # ------------------------------------------------------------------ #
    # async mode                                                          #
    # ------------------------------------------------------------------ #
    def _drain(self) -> None:
        """Wait for everything queued on the card (before a timed probe,
        so its clock does not run over earlier calls' work)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fence(self, timed: bool = False) -> None:
        """After a call: synchronize (``sync=True`` or a timed probe) or
        record a CUDA event for :meth:`sync` to wait on.  Nothing to do
        on the CPU."""
        if self.device.type != "cuda":
            return
        if self.sync_mode or timed:
            torch.cuda.synchronize(self.device)
            return
        pend = self._pending
        while pend and pend[0].query():     # retire finished calls
            pend.popleft()
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        pend.append(ev)

    def sync(self) -> "OffloadRuntime":
        """Wait until every tracked in-flight call has finished.  Every
        pending event is awaited even when one fails; the first error is
        re-raised with the others attached as notes."""
        first: Optional[BaseException] = None
        extras: list = []
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        for ev in pending:
            try:
                ev.synchronize()
            except RuntimeError as exc:     # a fault on the card surfaces here
                if first is None:
                    first = exc
                else:
                    extras.append(exc)
        if first is not None:
            for i, exc in enumerate(extras):
                first.add_note(f"sync: also failed ({i + 2}/"
                               f"{len(extras) + 1}): "
                               f"{type(exc).__name__}: {exc}")
            raise first
        return self

    # ------------------------------------------------------------------ #
    # trace buffer identity                                               #
    # ------------------------------------------------------------------ #
    def _trace_id(self, x: torch.Tensor, name: str = "") -> int:
        if self.trace is None:
            return -1
        bid = self._trace_ids.get(id(x))
        if bid is not None:
            return bid
        bid = self.trace.new_buffer(memspace.nbytes(x), name)
        self._trace_ids.put(id(x), bid, memspace.nbytes(x), anchor=x)
        return bid

    def alias_trace_id(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Source and its device placement are the same logical buffer."""
        if self.trace is None or id(dst) in self._trace_ids:
            return
        bid = self._trace_ids.get(id(src))
        if bid is None:
            return
        self._trace_ids.put(id(dst), bid, memspace.nbytes(dst), anchor=dst)

    # ------------------------------------------------------------------ #
    # the intercepted-call entry point: the staged dispatch pipeline      #
    # ------------------------------------------------------------------ #
    def blas_call(self, routine: str, m: int, n: int, k: int,
                  operands: Sequence[Tuple[str, torch.Tensor, float, bool]],
                  compute: Callable[..., torch.Tensor],
                  batch: int = 1,
                  key: Optional[Hashable] = None,
                  shard: Optional[Callable[..., Optional[TilePlan]]] = None,
                  kernel_compute: Optional[Callable] = None,
                  split_compute: Optional[Callable] = None,
                  split_check: Optional[Callable] = None) -> torch.Tensor:
        """Run one BLAS call through the dispatch pipeline.

        ``operands``: (role, tensor, device_reads_per_elem, written) — the
        metadata the memtier access-counter model consumes.  ``compute``:
        the arithmetic, taking the placed operand tensors in order.
        ``key``: hashable call-shape identity; when given, the offload
        decision is memoized in the dispatch cache.
        ``shard``: tile-plan builder ``n_devices -> TilePlan``, consulted
        only when the call offloads and more than one usable tier exists.
        ``kernel_compute``: the pallas-venue arithmetic (consulted only
        under ``kernel_path``; None means no kernel for this routine).
        ``split_compute``: split-precision factory ``(scheme, venue) ->
        compute`` and ``split_check``: sampled-residual estimator
        ``(out, *arrays) -> rel error`` (consulted only with a
        ``precision`` scheme; None means the call always runs native).

        The whole pipeline runs under the runtime lock, and any matrix
        product issued inside it bypasses the interceptors."""
        with self._lock:
            _TLS.depth = getattr(_TLS, "depth", 0) + 1
            try:
                return self._blas_call_locked(
                    routine, m, n, k, operands, compute, batch, key, shard,
                    kernel_compute, split_compute, split_check)
            finally:
                _TLS.depth -= 1

    def _blas_call_locked(self, routine, m, n, k, operands, compute, batch,
                          key, shard, kernel_compute, split_compute,
                          split_check) -> torch.Tensor:
        st = self.stats.routine(routine)
        st.calls += 1
        arrays = [op[1] for op in operands]
        if torch.compiler.is_compiling():
            # inside torch.compile tracing there is no placement to do
            return compute(*arrays)
        call = CallContext(routine=routine, m=m, n=n, k=k, batch=batch,
                           operands=operands, arrays=arrays,
                           compute=compute, key=key, shard=shard,
                           kernel_compute=kernel_compute,
                           split_compute=split_compute,
                           split_check=split_check,
                           traced=spans.enabled())
        # the site is read here, not in _pipeline: one frame more to walk
        # would cost the call more than its spans do
        if self.callsite_enabled:
            call.site_id = cs.fingerprint(routine)
            call.site = self.callsites.profile(call.site_id)
        if not call.traced:
            return self._pipeline(call, st)
        with spans.span("scilib.call.", routine):
            return self._pipeline(call, st)

    def _pipeline(self, call: CallContext, st: RoutineStats) -> torch.Tensor:
        """Decide, execute, fence and record one call."""
        if call.traced:
            with spans.span("scilib.decide"):
                decision = self._decide(call, st)
        else:
            decision = self._decide(call, st)
        if decision.timed:
            # a probe bills its own device work: drain what is queued
            self._drain()
        t0 = time.perf_counter()
        self._stage_plan(call, decision)
        out, devices = self._execute(call, decision, st)
        if decision.precision and decision.offload:
            # sampled-residual check + escalation; inside the timed
            # window so probe samples bill what the scheme really costs
            out = self._verify_split(call, decision, st, out)
        if call.traced:
            with spans.span("scilib.fence"):
                self._fence(timed=decision.timed)
        else:
            self._fence(timed=decision.timed)
        dt = time.perf_counter() - t0
        self._record(call, decision, out, devices, dt, st)
        return out

    # ------------------------------------------------------------------ #
    # decide: ordered stages emit the DispatchDecision                    #
    # ------------------------------------------------------------------ #
    def _decide(self, call: CallContext,
                st: RoutineStats) -> DispatchDecision:
        decision = None
        for stage in self.decision_stages:
            decision = stage(call, st)
            if decision is not None:
                break
        if decision.offload and not self.policy.offloads:
            decision.offload = False
            decision.why = "policy:host-only"
        if decision.offload and not self.health.any_usable():
            # degraded mode: every tier quarantined — keep serving on
            # the host path until a half-open probe readmits one
            decision.offload = False
            decision.why = "fallback:quarantined"
            self.stats.fallbacks += 1
            st.fallbacks += 1
            self._emit_event("fallback", "quarantined", 0)
        self._resolve_precision(call, decision)
        self._resolve_venue(call, decision)
        return decision

    def _resolve_precision(self, call: CallContext,
                           decision: DispatchDecision) -> None:
        """Precision: which numeric formulation runs the decided path.
        A no-op with ``precision`` off.  Runs before the venue resolution
        because a split call is pallas-eligible where a native fp64 call
        is not.  Adaptive decisions arrive with their precision already
        chosen by the probe schedule / lock and are left alone."""
        if not self.precision:
            return
        if not decision.offload or call.split_compute is None:
            # the host path (incl. policy/health vetoes of a split
            # probe) always runs native fp64
            decision.precision = ""
            return
        if decision.precision or decision.why.startswith("adaptive"):
            return
        scheme = prec.choose(self.precision,
                             thr.base_routine(call.routine),
                             call.k or call.m, self.precision_rtol)
        if scheme:
            decision.precision = scheme
            decision.why += f"+{scheme}"

    def _resolve_venue(self, call: CallContext,
                       decision: DispatchDecision) -> None:
        """Venue: which execution engine runs the decided path.  A no-op
        with ``kernel_path`` off.  Runs after the policy and health
        vetoes so a vetoed call is always ``host``; an adaptive decision
        arrives with its venue already chosen and is left alone."""
        if not self.kernel_path:
            return
        if not decision.offload:
            decision.venue = "host"
            return
        if decision.venue:
            return                      # adaptive stage already chose
        if (call.kernel_compute is not None
                or (decision.precision
                    and call.split_compute is not None)):
            # a split fp64 call is pallas-eligible even though native
            # fp64 gemm has no venue kernel: its passes run the gemm kernel
            decision.venue = "pallas"
            decision.why += "+kernel"
        else:
            decision.venue = "xla"

    def _stage_adaptive(self, call: CallContext,
                        st: RoutineStats) -> Optional[DispatchDecision]:
        """Per-site adaptive mode: probe the first ``adaptive_warmup``
        calls at each site on every venue, then lock the fastest."""
        if not self.adaptive or call.site is None:
            return None
        site = call.site
        # with kernel_path on and a kernel for this routine the warmup
        # rotates over three venues instead of two
        racing = self.kernel_path and call.kernel_compute is not None
        if site.locked is not None:
            # locked fast path: no threshold math, no N_avg derivation
            st.dispatch_hits += 1
            return DispatchDecision(
                site.locked, n_avg=0.0, why="adaptive:locked",
                venue=site.locked_venue if self.kernel_path else "",
                precision=site.locked_precision)
        nav = (thr.n_avg(call.routine, call.m, call.n, call.k)
               * (max(1, call.batch) ** (1.0 / 3.0)))
        if site.probes_done >= self.adaptive_warmup:
            locked = site.lock()
            if self.debug >= 1:
                label = (site.locked_venue if self.kernel_path
                         else ("offload" if locked else "host"))
                if site.locked_precision:
                    label += f"~{site.locked_precision}"
                print(f"[scilib] adaptive lock {site.site}: "
                      f"{label} ({site.locked_why})")
            if self.kernel_path:
                self._emit_event("venue",
                                 f"{site.locked_venue}:{site.site}", 0)
            st.dispatch_hits += 1
            return DispatchDecision(
                locked, n_avg=nav, why="adaptive:locked",
                venue=site.locked_venue if self.kernel_path else "",
                precision=site.locked_precision)
        st.dispatch_misses += 1
        # with a precision scheme and a split formulation, the warmup
        # also races the split variant like a venue
        split_scheme = ""
        if self.precision and call.split_compute is not None:
            split_scheme = prec.choose(
                self.precision, thr.base_routine(call.routine),
                call.k or call.m, self.precision_rtol)
        venue = site.probe_venue(3 if racing else 2,
                                 split=bool(split_scheme))
        if venue == "split":
            # venue stays "" here; _resolve_venue picks xla or pallas
            return DispatchDecision(True, n_avg=nav, why="adaptive:probe",
                                    timed=True, precision=split_scheme)
        return DispatchDecision(venue != "host", n_avg=nav,
                                why="adaptive:probe", timed=True,
                                venue=venue if self.kernel_path else "")

    def _stage_cached(self, call: CallContext,
                      st: RoutineStats) -> Optional[DispatchDecision]:
        """The memoized dispatch cache (fast path): one threshold
        derivation per call shape, two dict lookups thereafter."""
        if call.key is None or not self.dispatch_cache_enabled:
            return None
        dec = self._decisions.get(call.key)
        if dec is None:
            dec = thr.should_offload(call.routine, call.m, call.n, call.k,
                                     threshold=self.threshold,
                                     batch=call.batch)
            if len(self._decisions) > _DECISION_CACHE_LIMIT:
                self._decisions.clear()   # dynamic-shape churn guard
            self._decisions[call.key] = dec
            st.dispatch_misses += 1
            return DispatchDecision(dec[0], n_avg=dec[1], why="threshold")
        st.dispatch_hits += 1
        return DispatchDecision(dec[0], n_avg=dec[1], why="cache")

    def _stage_threshold(self, call: CallContext,
                         st: RoutineStats) -> DispatchDecision:
        """Terminal stage: derive the threshold rule per call (§3.3)."""
        st.dispatch_misses += 1
        offload, nav = thr.should_offload(call.routine, call.m, call.n,
                                          call.k, threshold=self.threshold,
                                          batch=call.batch)
        return DispatchDecision(offload, n_avg=nav, why="threshold")

    # ------------------------------------------------------------------ #
    # plan: consult the multi-device tile planner                         #
    # ------------------------------------------------------------------ #
    def _stage_plan(self, call: CallContext,
                    decision: DispatchDecision) -> DispatchDecision:
        n_avail = self.health.usable_count()
        if (decision.offload and call.shard is not None
                and n_avail > 1 and self.policy.shardable):
            kw = {}
            if self.kernel_path and decision.venue == "pallas":
                # sharded tiles follow the venue: the tile arithmetic
                # runs the kernel closures, under the same guarded units
                kw["venue"] = "pallas"
            if decision.precision and call.split_compute is not None:
                # split tiles: the same geometry, the split passes
                kw["precision"] = decision.precision
            decision.plan = call.shard(n_avail, **kw)
        return decision

    # ------------------------------------------------------------------ #
    # execute: host, sharded tiles, or whole-call offload                 #
    # ------------------------------------------------------------------ #
    def _execute(self, call: CallContext, decision: DispatchDecision,
                 st: RoutineStats) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        if not decision.offload:
            out = self._host_compute(call, st)
            st.on_host += 1
            return out, ()
        try:
            if decision.plan is not None:
                return self._sharded_call(st, decision.plan,
                                          site=call.site)
            return self._offload_whole(call, decision, st), ()
        except flt.OffloadError as exc:
            return self._fallback_host(call, decision, st, exc), ()

    def _host_compute(self, call: CallContext,
                      st: RoutineStats) -> torch.Tensor:
        """The host path: the call's closure on its operands, streamed to
        the session's device (:meth:`_harmonize`)."""
        arrays = self._harmonize(call.arrays, st)
        if not call.traced:
            return call.compute(*arrays)
        with spans.span("scilib.compute"):
            return call.compute(*arrays)

    def _offload_whole(self, call: CallContext, decision: DispatchDecision,
                       st: RoutineStats) -> torch.Tensor:
        """Single-device offload: the policy places every operand, the
        decided formulation runs on the placed tensors (the split one,
        the pallas venue's kernel closure, or the generic closure), the
        policy places the output.  Each operand movement, the kernel and
        the output placement are separate guarded units, attributed to
        the whole-call device tier."""
        site = call.site
        dev = self._whole_device()
        placed, budget_used = [], 0
        ai = self._arith_intensity(call.routine, call.m, call.n, call.k,
                                   call.arrays, call.batch)
        for (role, x, reads, written) in call.operands:
            if isinstance(self.policy, pol.CounterPolicy):
                p = self._guarded(
                    "transfer",
                    lambda x=x, r=reads, w=written, b=budget_used:
                        self.policy.place_operand(
                            self, x, reads_per_elem=r, written=w, ai=ai,
                            budget_used=b),
                    device=dev, nbytes=memspace.nbytes(x), st=st)
            else:
                p = self._guarded(
                    "transfer",
                    lambda x=x: self.policy.place_operand(self, x),
                    device=dev, nbytes=memspace.nbytes(x), st=st)
            budget_used += p.moved_bytes
            st.bytes_in += p.moved_bytes
            st.cache_hits += int(p.cache_hit)
            st.cache_misses += int(not p.cache_hit)
            if site is not None:
                site.observe_residency(p.cache_hit)
            if p.cache_hit:
                self._count_reuse(x)
            if p.moved_bytes or p.cache_hit:
                self.alias_trace_id(x, p.array)
            placed.append(p.array)
        # harmonize outside the kernel guard: a retried kernel must not
        # re-bill transient streaming bytes
        call.placed = self._harmonize(placed, st)
        if decision.precision and call.split_compute is not None:
            compute = call.split_compute(decision.precision, decision.venue)
        elif (decision.venue == "pallas"
              and call.kernel_compute is not None):
            compute = call.kernel_compute
        else:
            compute = call.compute
        args = call.placed

        def kernel():
            return compute(*args)
        if call.traced:
            with spans.span("scilib.compute"):
                out = self._guarded("kernel", kernel, device=dev, nbytes=0,
                                    st=st)
        else:
            out = self._guarded("kernel", kernel, device=dev, nbytes=0,
                                st=st)
        out_p = self._guarded(
            "transfer", lambda: self.policy.place_output(self, out),
            device=dev, nbytes=memspace.nbytes(out), st=st)
        st.bytes_out += out_p.moved_bytes
        st.offloaded += 1
        return out_p.array

    def _verify_split(self, call: CallContext, decision: DispatchDecision,
                      st: RoutineStats, out: torch.Tensor) -> torch.Tensor:
        """Post-execution escalation check of a split result.

        The sampled residual (one O(n^2) fp64 matvec chain against the
        O(n^3) call) estimates the forward relative error; a result over
        ``precision_rtol`` is discarded and the call reruns native fp64,
        so accuracy degradation is bounded, never silent.  The check
        reads the operands the split ran on (``call.placed``, on the
        device tier), where the reference reads the caller's arrays; a
        sharded call placed blocks, not whole operands, so its check
        reads the caller's arrays on the result's device.  The native
        rerun streams the caller's arrays as the reference's does.
        Reading the residual waits for the result."""
        if call.split_check is None:
            return out
        placed = call.placed
        if placed is None:
            placed = [a.to(out.device) for a in call.arrays]
        rel = float(call.split_check(out, *placed))
        if rel <= self.precision_rtol:
            return out
        st.escalations += 1
        decision.why += "+esc"
        self._emit_event("escalate",
                         f"{decision.precision}:{call.routine}", 0)
        if call.site is not None:
            # a site whose scheme misses its bound must never lock it
            call.site.split_bad = True
        if self.debug >= 1:
            print(f"[scilib] {call.routine} {decision.precision} "
                  f"residual {rel:.2e} > rtol {self.precision_rtol:.2e}"
                  f" -> native fp64")
        return call.compute(*self._harmonize(call.arrays, st))

    def _harmonize(self, arrays, st: RoutineStats) -> list:
        """Operands a policy left on the host are streamed to the device
        for this call only (the placement registry is untouched), so the
        arithmetic always runs where the session's device is.  This is
        not a placement decision (and the host fallback itself runs
        through here), so it is never a fault-injection site."""
        out = []
        for a in arrays:
            if memspace.tier_of(a) != memspace.DEVICE:
                st.transient_bytes += memspace.nbytes(a)
                if not self.memspace.simulated:
                    with spans.span("scilib.move.stream"):
                        a = a.to(self.device)
            out.append(a)
        return out

    # ------------------------------------------------------------------ #
    # record: statistics, site profile, trace                             #
    # ------------------------------------------------------------------ #
    def _record(self, call: CallContext, decision: DispatchDecision,
                out: torch.Tensor, devices: Tuple[int, ...], dt: float,
                st: RoutineStats) -> None:
        st.seconds += dt
        if decision.offload and decision.venue == "pallas":
            st.kernel_calls += 1
            st.kernel_seconds += dt
        if decision.offload and decision.precision:
            st.split_calls += 1
            st.split_seconds += dt
        site = call.site
        if site is not None:
            if decision.timed:
                site.observe_probe(decision.offload, dt,
                                   venue=decision.venue,
                                   precision=decision.precision)
            site.observe(decision.n_avg,
                         _flops_of(call.routine, call.m, call.n, call.k,
                                   call.batch),
                         dt, decision.offload, venue=decision.venue,
                         precision=decision.precision)
        solver_id = ""
        if self._solver_stack:
            span = self._solver_stack[-1]
            solver_id = span.span_id
            self.stats.solver(span.name).calls += 1
        self._record_trace(call, decision, out, devices, dt, solver_id)
        if self.debug >= 2:
            where = "host" if not decision.offload else (
                f"shard[{len(devices)} tiles]" if devices else
                (decision.venue or "offload"))
            print(f"[scilib] {call.routine} m={call.m} n={call.n} "
                  f"k={call.k} navg={decision.n_avg:.0f} {where} "
                  f"({decision.why})")

    def _count_reuse(self, x: torch.Tensor) -> None:
        bid = self._trace_ids.get(id(x))
        if bid is not None:
            self._reuse_by_buffer[bid] = self._reuse_by_buffer.get(bid, 0) + 1

    def mean_buffer_reuse(self) -> float:
        if not self._reuse_by_buffer:
            return 0.0
        return sum(self._reuse_by_buffer.values()) / len(self._reuse_by_buffer)

    @staticmethod
    def _arith_intensity(routine, m, n, k, arrays, batch) -> float:
        size = sum(memspace.nbytes(a) for a in arrays)
        return _flops_of(routine, m, n, k, batch) / max(1, size)

    def _record_trace(self, call: CallContext, decision: DispatchDecision,
                      out: torch.Tensor, devices: Tuple[int, ...],
                      seconds: float, solver_id: str = "") -> None:
        if self.trace is None:
            return
        ops = []
        for (role, x, reads, written) in call.operands:
            bid = self._trace_id(x, role)
            ops.append((role, bid, memspace.nbytes(x) // max(1, call.batch),
                        reads, written))
        # the output aliases the written operand's logical buffer; a fresh
        # output gets its own buffer, recorded on the call
        out_buf, out_nbytes = -1, 0
        for (role, x, reads, written) in call.operands:
            if written:
                self.alias_trace_id(x, out)
                break
        else:
            out_buf = self._trace_id(out, "OUT")
            out_nbytes = memspace.nbytes(out)
        self.trace.calls.append(BlasCall(
            routine=call.routine, m=call.m, n=call.n, k=call.k,
            batch=call.batch, operands=tuple(ops), devices=tuple(devices),
            callsite_id=call.site_id, seconds=seconds,
            out_buf=out_buf, out_nbytes=out_nbytes, venue=decision.venue,
            precision=decision.precision, solver_id=solver_id))


# --------------------------------------------------------------------- #
# context-local active runtime                                           #
# --------------------------------------------------------------------- #
_ACTIVE: ContextVar[Optional[OffloadRuntime]] = (
    ContextVar("scilib_torch_active_runtime", default=None))


def activate(runtime: Optional[OffloadRuntime]) -> None:
    """Make ``runtime`` the dispatch target of the current context, with
    its tier mapping, fault hook and debug level (None deactivates all
    of them).  Sessions drive this."""
    _ACTIVE.set(runtime)
    if runtime is None:
        memspace.uninstall()
        memspace.set_fault_hook(None)
        memspace.set_debug(0)
    else:
        memspace.install(runtime.memspace)
        memspace.set_fault_hook(runtime._transfer_fault_hook())
        memspace.set_debug(runtime.debug)


def active() -> Optional[OffloadRuntime]:
    return _ACTIVE.get()


def install(policy: Optional[str] = None,
            threshold: Optional[float] = None,
            record_trace: bool = True, sync: Optional[bool] = None,
            device_bytes: Optional[int] = None,
            config: Optional[OffloadConfig] = None,
            device=None) -> OffloadRuntime:
    """The ``.init_array`` analogue: a shim over an implicit
    :class:`~repro_torch.core.session.Session` without symbol
    interception (the dlsym-mode surface).  The ``SCILIB_*`` knobs are
    honoured through :meth:`OffloadConfig.legacy`; an explicit ``config``
    bypasses that resolution and the environment.  ``device`` is the
    session's (``None``: ``cuda:0``; ``"cpu"``: the simulated tiers)."""
    from repro_torch.core import session as ses
    if config is None:
        config = OffloadConfig.legacy(policy=policy, threshold=threshold,
                                      sync=sync, device_bytes=device_bytes)
    return ses.open_legacy(config, record_trace=record_trace,
                           intercept=False, device=device).runtime


def uninstall() -> Optional[RuntimeStats]:
    """The ``.fini_array`` analogue: close the most recent legacy session
    (draining in-flight work and dumping its trace to
    ``config.trace_path``) and return its final statistics."""
    from repro_torch.core import session as ses
    return ses.close_legacy()


def pin(x: torch.Tensor) -> torch.Tensor:
    """Pin a buffer on the active runtime's device tier (no-op when no
    runtime is active).  See :meth:`OffloadRuntime.pin`."""
    rt = _ACTIVE.get()
    return x if rt is None else rt.pin(x)


def unpin(x: torch.Tensor) -> None:
    """Release a :func:`pin` (no-op when no runtime is active)."""
    rt = _ACTIVE.get()
    if rt is not None:
        rt.unpin(x)
