"""Trace-driven simulation of the paper's data-movement policies (§3.2).

The port's copy of ``repro/memtier/simulator.py``, over the port's
:mod:`repro_torch.core.residency` and :mod:`repro_torch.core.trace`: the
same trace replays to the same :class:`PolicyReport` in both packages,
and a solver-tier trace to its live per-solver counters.

Replays a level-3 BLAS trace (``repro_torch.core.trace.Trace``) against the
page table + bandwidth model and produces the same accounting the paper
reports in Tables 3 and 5: total time, BLAS time, data-movement time, and
per-buffer reuse counts.

Policies:

* ``cpu``      — baseline: everything on host BLAS (paper's NVPL runs).
* ``memcopy``  — Strategy 1: stage operands to device memory around every
                 offloaded call (what LIBSCI_ACC/NVBLAS-style tools do).
* ``counter``  — Strategy 2: pass host pointers; a model of the Hopper
                 access-counter migration decides page movement (§4.4.1).
* ``dfu``      — Strategy 3, the paper's contribution: Device First-Use.
                 move_pages() the operand buffers to device residency on
                 first device use; they stay resident thereafter.
* ``pinned``   — `numactl -m 1`: allocate everything device-resident.

The access-counter model is a *reconstruction*: NVIDIA's criteria are
undocumented ("details of the migration criteria are unknown", §4.4.1). The
rules below reproduce every row of the paper's Table 6, including the
counter-intuitive refusal to migrate the 1.8 GB B matrix of the PARSEC
shape, and the run-to-run instability of the 200 MB row:

  R1. read operands migrate iff their per-element device read multiplicity
      is >= ``counter_reuse_min`` (B in the skinny dgemm is re-read only
      M=32 times per element -> stays), subject to
  R2. a per-call migrated-byte budget ``counter_byte_budget`` (second
      3.2 GB operand of the 20000^3 dgemm -> stays), and
  R3. written operands migrate only when small and the kernel is compute
      bound (C of 1000^3 migrates; C of the skinny shape never does).
  R4. mid-size buffers (>=100 MB) migrate with one-call delay on a seeded
      coin flip (the "yes?" rows).

**Multi-device replay** (``n_devices > 1``): the DFU policy models the
runtime's BLASX-style tile scheduler — super-threshold calls split into a
2-D tile grid executed concurrently across N devices, buffers assigned to
a device round-robin on first use and staying put thereafter (affinity),
each device with its own HBM capacity and H2D accounting
(``per_device_h2d``).  Read operands replicate along one grid axis (the
tile-communication amplification of 2-D decompositions); migration links
to different devices run in parallel.

**Residency accounting** is the live runtime's own engine: one
:class:`repro_torch.core.residency.ResidencyStore` per device tier tracks
which buffers are device-resident, under two admission semantics —

* ``spec.device_capacity`` is the *HBM* limit: a migration that cannot
  fit is refused and the buffer stays remote (``evict_lru=True``
  restores residents to host to make room, the pre-engine behaviour);
* ``device_bytes`` models the runtime's ``SCILIB_DEVICE_BYTES`` registry
  cap: admissions always succeed and the eviction policy (``evict`` —
  ``lru``/``lfu``/``refetch``) pushes other residents back to host,
  exactly like the live store.  Fresh outputs of offloaded calls
  (``BlasCall.out_buf``) are born device-resident and occupy cap bytes,
  again like the live run — which is what makes the replayed eviction
  and refetch counts comparable, count-for-count, with a live capped
  run's trace events.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.residency import ResidencyStore
from repro_torch.core.trace import BlasCall, Trace
from repro_torch.memtier.pagetable import Buffer, PageTable
from repro_torch.memtier.spec import GH200, HardwareSpec, MemKind

POLICIES = ("cpu", "memcopy", "counter", "dfu", "pinned")


@dataclasses.dataclass
class PolicyReport:
    """Accounting identical in structure to the paper's Tables 3/5 rows."""

    policy: str
    spec: str
    threshold: float
    n_devices: int = 1
    # residency-engine configuration + counters of this replay
    device_bytes: Optional[int] = None   # SCILIB_DEVICE_BYTES cap model
    evict: str = "lru"                   # SCILIB_EVICT policy model
    evictions: int = 0                   # cap-pressure evictions
    refetches: int = 0                   # evicted entries placed again
    refetched_bytes: int = 0
    # fault-tolerance counters replayed off the trace's fault events
    # (repro_torch.core.faults): a faulted live run and its replay agree
    # on these exactly — the trace records where the run degraded
    faults: int = 0
    retries: int = 0
    fallbacks: int = 0
    quarantines: int = 0
    recoveries: int = 0
    #: tenant this replay is scoped to ("" = whole trace); session-tagged
    #: traces from a shared-pool run reconcile per-tenant this way
    session: str = ""
    # kernel-path replay (OffloadConfig.kernel_path): offloaded calls the
    # recording run executed on the pallas venue, and the per-routine
    # pallas/xla speed ratios calibrated from its probe timings.  Both
    # stay at their defaults replaying a venue-free (default-off) trace.
    kernel_calls: int = 0
    venue_ratio: Dict[str, float] = dataclasses.field(default_factory=dict)
    # precision replay (OffloadConfig.precision): offloaded calls the
    # recording run executed under a split scheme, escalations its
    # residual checks fired, and the per-routine split/native cost
    # ratios calibrated from its own timings.  All stay at defaults
    # replaying a precision-free (default-off) trace.
    split_calls: int = 0
    escalations: int = 0
    precision_ratio: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # solver-span replay (repro_torch.solvers): spans tallied off the trace's
    # ``solver_begin`` events, per-solver call/panel counters off each
    # call's ``solver_id`` tag — a live LAPACK-tier run and its replay
    # agree on these exactly.  Both stay at their defaults replaying a
    # span-free (default-off) trace.
    solver_spans: int = 0
    per_solver: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    total_s: float = 0.0
    blas_device_s: float = 0.0
    blas_host_s: float = 0.0
    movement_s: float = 0.0          # reported separately, like the paper
    bytes_host_to_dev: int = 0
    bytes_dev_to_host: int = 0
    offloaded_calls: int = 0
    host_calls: int = 0
    per_routine_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    mean_reuse: float = 0.0
    max_reuse: float = 0.0
    n_migrated_buffers: int = 0
    device_bytes_peak: int = 0
    # multi-device replay: H2D bytes landing on each device tier
    per_device_h2d: Dict[int, int] = dataclasses.field(default_factory=dict)
    # per-call-site time, keyed by BlasCall.callsite_id (traces recorded
    # before call-site identity existed simply leave this empty)
    per_site_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def moved_bytes(self) -> int:
        """Total link traffic, both directions (the autotuner's second
        objective after predicted time)."""
        return self.bytes_host_to_dev + self.bytes_dev_to_host

    def row(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "total_s": round(self.total_s, 3),
            "blas_s": round(self.blas_device_s + self.blas_host_s, 3),
            "movement_s": round(self.movement_s, 3),
            "offloaded": self.offloaded_calls,
            "on_host": self.host_calls,
            "mean_reuse": round(self.mean_reuse, 1),
        }


class MemTierSimulator:
    """One application run under one policy on one hardware spec."""

    # Access-counter model constants (see module docstring).
    counter_reuse_min: float = 100.0
    counter_byte_budget: float = 3.4e9
    counter_c_small: float = 16e6
    counter_ai_min: float = 30.0
    counter_delay_prob: float = 0.35

    def __init__(self, spec: HardwareSpec = GH200, *, policy: str = "dfu",
                 threshold: float = 500.0, aligned_alloc: bool = False,
                 seed: int = 0, evict_lru: bool = False,
                 n_devices: int = 1,
                 device_bytes: Optional[int] = None,
                 evict: str = "lru",
                 session: str = "",
                 kernel_path: bool = False,
                 precision: str = ""):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        self.spec = spec
        self.policy = policy
        self.threshold = threshold
        self.aligned_alloc = aligned_alloc
        self.pt = PageTable(spec)
        self.rng = np.random.default_rng(seed)
        self.evict_lru = evict_lru
        self.n_devices = max(1, int(n_devices))
        self.device_bytes = device_bytes if device_bytes else None
        self.session = session
        # kernel-path replay: calls the live run tagged venue="pallas"
        # execute under a per-routine speed ratio calibrated from the
        # trace's own probe timings (see _calibrate_venues).  Off by
        # default — a kernel-off replay multiplies nothing and stays
        # float-identical to the pre-venue model.
        self.kernel_path = bool(kernel_path)
        self._kmult = 1.0
        self._venue_ratio: Dict[str, float] = {}
        # precision replay: calls the live run tagged with a split
        # scheme execute under a per-routine split/native cost ratio
        # calibrated from the trace (_calibrate_precision).  Off by
        # default — a precision-off replay multiplies nothing and stays
        # float-identical to the pre-precision model.
        self.precision = str(precision)
        self._pmult = 1.0
        self._precision_ratio: Dict[str, float] = {}
        self.report = PolicyReport(policy=policy, spec=spec.name,
                                   threshold=threshold,
                                   n_devices=self.n_devices,
                                   device_bytes=self.device_bytes,
                                   evict=evict,
                                   session=session)
        self._bufs: Dict[int, Buffer] = {}       # trace buf id -> Buffer
        self._delayed: Dict[int, int] = {}       # counter: deferred once
        self._denied: set = set()                # counter: budget-refused
        # the residency engine, one store per device tier: the same
        # ResidencyStore class the live runtime's registries use, so
        # capacity checks, cap evictions, refetch detection, LRU order
        # and the counters all share one implementation.
        self._stores = [
            ResidencyStore(f"dev{d}" if self.n_devices > 1
                           else "placements",
                           cap=self.device_bytes, policy=evict,
                           on_evict=self._evict_to_host(d))
            for d in range(self.n_devices)]
        # multi-device DFU: buffer -> assigned device (round-robin with
        # affinity — first placement sticks)
        self._dev_of: Dict[int, int] = {}
        self._rr_dev = 0
        self._out_seq = 0            # synthetic keys for aliased outputs

    @classmethod
    def from_config(cls, config, spec: HardwareSpec = GH200,
                    **kw) -> "MemTierSimulator":
        """A simulator modeling one :class:`repro_torch.core.config.
        OffloadConfig` — the replay side of the tune->deploy loop: the
        autotuner emits a config file, and this constructor predicts
        what a session running that config will do (same policy,
        resolved threshold, device-tier count, cap and eviction)."""
        return cls(spec, policy=config.policy,
                   threshold=config.resolved_threshold(),
                   n_devices=config.resolved_devices(),
                   device_bytes=config.device_bytes,
                   evict=config.evict,
                   kernel_path=config.kernel_path,
                   precision=config.precision, **kw)

    def _evict_to_host(self, dev: int):
        """Cap pressure on one device store: bounce the victim's pages
        back to host and bill the link, like the live store re-tagging
        plus the next refetch the evicted buffer will pay."""
        def _on_evict(key, buf, nbytes):
            # one Buffer can back two entries — the operand placement
            # and its aliased-output twin, like the live registry's
            # id(c)/id(out) pair.  Only the last entry standing moves
            # the pages; evicting a twin bills the link without
            # un-homing the still-resident sibling.
            if any(s.entry(k).payload is buf
                   for s in self._stores for k in s.keys()):
                spec = self.spec
                self.report.movement_s += nbytes / spec.effective_migrate_bw()
                self.report.bytes_dev_to_host += nbytes
                return
            moved, secs = self.pt.move_pages(buf, MemKind.HOST)
            self.report.movement_s += secs
            self.report.bytes_dev_to_host += moved
        return _on_evict

    def _assign_dev(self, bid: int) -> int:
        """The device tier a buffer belongs to (round-robin assignment
        on first device use, sticky thereafter — the affinity rule)."""
        if self.n_devices == 1:
            return 0
        dev = self._dev_of.get(bid)
        if dev is None:
            dev = self._rr_dev % self.n_devices
            self._rr_dev += 1
            self._dev_of[bid] = dev
        return dev

    # ------------------------------------------------------------------ #
    def _buffer(self, trace: Trace, bid: int) -> Buffer:
        if bid not in self._bufs:
            buf = self.pt.malloc(trace.buffer_sizes[bid],
                                 trace.buffer_names[bid],
                                 align_to_page=self.aligned_alloc)
            if self.policy == "pinned":
                moved, _ = self.pt.move_pages(buf, MemKind.DEVICE)
                # numactl binding happens at allocation: free placement.
                buf.migrations = 0
                buf.bytes_migrated = 0
                # pinned entries survive any cap: numactl bindings are
                # not evictable, and the store knows it
                self._stores[self._assign_dev(bid)].put(
                    bid, buf, buf.size, pinned=True)
            self._bufs[bid] = buf
        return self._bufs[bid]

    # ------------------------------------------------------------------ #
    # per-call cost model                                                 #
    # ------------------------------------------------------------------ #
    def _host_call(self, call: BlasCall, bufs: List[Buffer]) -> float:
        t_mem = sum(self.pt.stream_time(b, nb * call.batch, accessor="cpu")
                    for b, (_, _, nb, _, _) in zip(bufs, call.operands))
        eff = self.spec.eff("cpu", call.routine)
        t = max(call.flops / (self.spec.cpu_flops * eff), t_mem)
        self.report.blas_host_s += t
        self.report.host_calls += 1
        return t

    def _device_kernel(self, call: BlasCall, bufs: List[Buffer]) -> float:
        """Device BLAS on operands wherever their pages currently live."""
        spec = self.spec
        t_mem = sum(self.pt.stream_time(b, nb * call.batch, accessor="gpu")
                    for b, (_, _, nb, _, _) in zip(bufs, call.operands))
        # §4.4.3 pathology: system-allocated device memory is slower for the
        # device unless page-aligned; memory-bound paths suffer most.
        on_dev = [b for b in bufs if b.resident_bytes(MemKind.DEVICE) > 0]
        sysmalloc = bool(on_dev) and self.policy != "memcopy"
        if sysmalloc and any(not b.aligned for b in on_dev):
            mem_pen, comp_pen = spec.unaligned_penalty, spec.sysmalloc_penalty
        elif sysmalloc:
            mem_pen = comp_pen = 1.0    # aligned matches cudaMalloc (T.8)
        else:
            mem_pen = comp_pen = 1.0
        eff = spec.eff("gpu", call.routine)
        t = max(call.flops / (spec.gpu_flops * eff) * comp_pen,
                t_mem * mem_pen)
        if self._kmult != 1.0:          # pallas-venue calibrated ratio
            t *= self._kmult
        if self._pmult != 1.0:          # split-scheme calibrated ratio
            t *= self._pmult
        t += spec.kernel_launch_s
        self.report.blas_device_s += t
        self.report.offloaded_calls += 1
        for b in bufs:
            if b.fully_on(MemKind.DEVICE):
                b.device_uses += 1
        return t

    # ------------------------------------------------------------------ #
    # policies                                                            #
    # ------------------------------------------------------------------ #
    def _memcopy(self, call: BlasCall, bufs: List[Buffer]) -> float:
        spec, t_move = self.spec, 0.0
        for b, (_, _, nb, _, written) in zip(bufs, call.operands):
            nbytes = nb * call.batch
            t_move += nbytes / spec.link_bw            # H->D stage in
            self.report.bytes_host_to_dev += nbytes
            if written:
                t_move += nbytes / spec.link_bw        # D->H result out
                self.report.bytes_dev_to_host += nbytes
        # kernel runs on cudaMalloc staging: fully local, no malloc penalty
        t_mem = call.bytes_touched / spec.gpu_local_bw
        eff = spec.eff("gpu", call.routine)
        t_k = max(call.flops / (spec.gpu_flops * eff), t_mem)
        if self._kmult != 1.0:          # pallas-venue calibrated ratio
            t_k *= self._kmult
        if self._pmult != 1.0:          # split-scheme calibrated ratio
            t_k *= self._pmult
        t_k += spec.kernel_launch_s
        self.report.blas_device_s += t_k
        self.report.offloaded_calls += 1
        self.report.movement_s += t_move
        return t_k + t_move

    def _dfu(self, call: BlasCall, bufs: List[Buffer]) -> float:
        """Device First-Use: move_pages() everything on first device use.

        The residency store is the arbiter: a hit is a free reuse, a
        miss migrates (HBM capacity permitting) and registers — under a
        ``device_bytes`` cap the registration itself may evict other
        residents, exactly like the live placement store.
        """
        t_move = 0.0
        store = self._stores[0]
        for b in bufs:
            if store.get(b.buf_id) is not None:
                continue                        # resident: reuse is free
            if not b.fully_on(MemKind.DEVICE):
                if not store.reserve(b.size,
                                     limit=self.spec.device_capacity,
                                     evict=self.evict_lru):
                    continue                    # HBM full: stay remote
                moved, secs = self.pt.move_pages(b, MemKind.DEVICE)
                t_move += secs
                self.report.bytes_host_to_dev += moved
            store.put(b.buf_id, b, b.size)
        self.report.movement_s += t_move
        return self._device_kernel(call, bufs) + t_move

    def _dfu_multi(self, call: BlasCall, bufs: List[Buffer]) -> float:
        """N-device DFU: the runtime's tile scheduler under the cost model.

        Buffers are dealt to devices round-robin on first device use and
        stay put (affinity); the call executes as a gm x gn tile grid,
        one tile round per device concurrently.  Read operands replicate
        along one grid axis — the communication amplification every 2-D
        decomposition pays — while the written operand splits per tile.
        """
        spec, n_dev = self.spec, self.n_devices
        t_move_dev: Dict[int, float] = {}
        for b in bufs:
            dev = self._assign_dev(b.buf_id)
            store = self._stores[dev]
            if store.get(b.buf_id) is not None:
                continue
            if not b.fully_on(MemKind.DEVICE):
                if not store.reserve(b.size,
                                     limit=spec.device_capacity,
                                     evict=self.evict_lru):
                    continue
                moved, secs = self.pt.move_pages(b, MemKind.DEVICE)
                self.report.per_device_h2d[dev] = (
                    self.report.per_device_h2d.get(dev, 0) + moved)
                self.report.bytes_host_to_dev += moved
                t_move_dev[dev] = t_move_dev.get(dev, 0.0) + secs
            store.put(b.buf_id, b, b.size)
        # links to distinct devices run in parallel: the slowest one gates
        t_move = max(t_move_dev.values(), default=0.0)
        self.report.movement_s += t_move
        gm = max(1, math.isqrt(n_dev))
        gn = -(-n_dev // gm)
        tiles = gm * gn
        axis_frac = (1.0 / gm, 1.0 / gn)
        t_mem, nread = 0.0, 0
        for b, (_, _, nb, _, written) in zip(bufs, call.operands):
            if written:
                frac = 1.0 / tiles
            else:
                frac = axis_frac[min(nread, 1)]
                nread += 1
            t_mem += self.pt.stream_time(b, int(nb * call.batch * frac),
                                         accessor="gpu")
        on_dev = [b for b in bufs if b.resident_bytes(MemKind.DEVICE) > 0]
        if on_dev and any(not b.aligned for b in on_dev):
            mem_pen, comp_pen = spec.unaligned_penalty, spec.sysmalloc_penalty
        else:
            mem_pen = comp_pen = 1.0
        eff = spec.eff("gpu", call.routine)
        per_tile = max(call.flops / tiles / (spec.gpu_flops * eff) * comp_pen,
                       t_mem * mem_pen)
        if self._kmult != 1.0:          # pallas-venue calibrated ratio
            per_tile *= self._kmult
        if self._pmult != 1.0:          # split-scheme calibrated ratio
            per_tile *= self._pmult
        per_tile += spec.kernel_launch_s
        t_k = per_tile * (-(-tiles // n_dev))   # tile rounds per device
        self.report.blas_device_s += t_k
        self.report.offloaded_calls += 1
        for b in bufs:
            if b.fully_on(MemKind.DEVICE):
                b.device_uses += 1
        return t_k + t_move

    def _counter(self, call: BlasCall, bufs: List[Buffer]) -> float:
        """Model of Hopper's access-counter migration (§4.4.1, Table 6)."""
        spec = self.spec
        store = self._stores[0]
        migrated_this_call = 0
        t_mig = 0.0
        ai = call.flops / max(1, call.bytes_touched)   # arithmetic intensity
        for b, (_, _, nb, reads, written) in zip(bufs, call.operands):
            nbytes = nb * call.batch
            if store.get(b.buf_id) is not None:
                continue                         # resident: recency touch
            if b.fully_on(MemKind.DEVICE):
                continue
            self.pt.record_device_reads(b, reads)
            if written:                                         # rule R3
                ok = nbytes <= self.counter_c_small and ai >= self.counter_ai_min
            elif b.buf_id in self._denied:
                ok = False               # budget refusals are sticky (T.6)
            elif reads < self.counter_reuse_min:                # rule R1
                ok = False
            elif migrated_this_call + nbytes > self.counter_byte_budget:
                ok = False                                      # rule R2
                self._denied.add(b.buf_id)
            else:
                ok = True
            if ok and 100e6 <= nbytes < 1e9:                    # rule R4
                seen = self._delayed.get(b.buf_id, 0)
                self._delayed[b.buf_id] = seen + 1
                if seen == 0 and self.rng.random() < self.counter_delay_prob:
                    ok = False
            if ok and store.reserve(b.size, limit=spec.device_capacity,
                                    evict=self.evict_lru):
                moved, secs = self.pt.move_pages(b, MemKind.DEVICE)
                t_mig += secs
                migrated_this_call += moved
                self.report.bytes_host_to_dev += moved
                store.put(b.buf_id, b, b.size)
        # counter migration happens behind the kernel: its cost is billed
        # to BLAS time, exactly how the paper reports it ("included").
        t_k = self._device_kernel(call, bufs)
        self.report.blas_device_s += t_mig
        return t_k + t_mig

    # ------------------------------------------------------------------ #
    def _born_on_device(self, buf: Buffer) -> None:
        """Mark a fresh output buffer device-resident with no link cost
        and no migration event: offloaded outputs are device-born, the
        exact analogue of the live runtime's ``place_output``."""
        mask = buf.numa != int(MemKind.DEVICE)
        n = int(np.count_nonzero(mask))
        if n == 0:
            return
        self.pt.used[MemKind.HOST] -= n * buf.page_size
        self.pt.used[MemKind.DEVICE] += n * buf.page_size
        buf.numa[mask] = int(MemKind.DEVICE)
        buf.dev_pages = buf.n_pages

    def _register_output(self, trace: Trace, call: BlasCall) -> None:
        """DFU only: the live runtime registers *every* offloaded
        output, so the replay must too or capped eviction counts drift.

        A fresh output (no written operand) carries its own trace
        buffer (``out_buf``).  An output that aliases a written operand
        shares that operand's trace buffer — but the live registry
        still holds two entries (the operand's placed copy under
        ``id(c)`` and the output under ``id(out)``; the caller's old C
        stays valid and cached), so the replay adds a synthetic twin
        entry of the same size backed by the same Buffer."""
        if call.out_buf >= 0 and call.out_buf in trace.buffer_sizes:
            buf = self._buffer(trace, call.out_buf)
            self._born_on_device(buf)
            dev = self._assign_dev(call.out_buf)
            self._stores[dev].put(call.out_buf, buf,
                                  call.out_nbytes or buf.size)
            return
        for _, bid, nb, _, written in call.operands:
            if written:
                buf = self._buffer(trace, bid)
                self._born_on_device(buf)
                dev = self._assign_dev(bid)
                self._out_seq += 1
                self._stores[dev].put(("out", self._out_seq), buf,
                                      nb * call.batch)
                return

    # ------------------------------------------------------------------ #
    def _calibrate_venues(self, trace: Trace) -> Dict[str, float]:
        """Per-routine pallas/xla speed ratio from the trace's own
        measured per-call wall times (the adaptive probe timings a
        kernel-path run records in ``BlasCall.seconds``/``venue``).

        Best-sample per venue, like ``CallSiteProfile.lock`` — the first
        call on each venue pays jit compilation and the minimum is
        robust to it.  A routine seen on only one venue gets no ratio
        (the generic model applies, ratio 1.0); ratios clamp to
        [0.1, 10] so one mistimed probe cannot distort the replay."""
        best: Dict[tuple, float] = {}
        for call in trace:
            if call.venue in ("xla", "pallas") and call.seconds > 0:
                k = (call.routine, call.venue)
                if call.seconds < best.get(k, float("inf")):
                    best[k] = call.seconds
        ratios: Dict[str, float] = {}
        for (routine, venue) in best:
            if venue != "pallas":
                continue
            xla = best.get((routine, "xla"))
            if xla:
                r = best[(routine, "pallas")] / xla
                ratios[routine] = min(10.0, max(0.1, r))
        return ratios

    # ------------------------------------------------------------------ #
    def _calibrate_precision(self, trace: Trace) -> Dict[str, float]:
        """Per-routine split/native cost ratio from the trace's own
        measured per-call wall times, exactly like
        :meth:`_calibrate_venues` — best sample per side (robust to the
        one-off jit cost of the first call), clamped to [0.1, 10].  A
        routine seen only split (or only native) gets no ratio and the
        generic model applies unchanged."""
        best: Dict[tuple, float] = {}
        for call in trace:
            if call.seconds > 0 and call.venue != "host":
                k = (call.routine,
                     "split" if call.precision else "native")
                if call.seconds < best.get(k, float("inf")):
                    best[k] = call.seconds
        ratios: Dict[str, float] = {}
        for (routine, kind) in best:
            if kind != "split":
                continue
            native = best.get((routine, "native"))
            if native:
                r = best[(routine, "split")] / native
                ratios[routine] = min(10.0, max(0.1, r))
        return ratios

    # ------------------------------------------------------------------ #
    def run(self, trace: Trace) -> PolicyReport:
        # fault replay: a call the live run fell back to host (retry
        # exhaustion or total quarantine) is host-bound here too — the
        # fallback events carry the call index they interleaved at
        forced_host = {e.call_index for e in trace.events
                       if e.kind == "fallback"
                       and (not self.session
                            or e.session == self.session)}
        if self.kernel_path:
            self._venue_ratio = self._calibrate_venues(trace)
            self.report.venue_ratio = dict(self._venue_ratio)
        if self.precision:
            self._precision_ratio = self._calibrate_precision(trace)
            self.report.precision_ratio = dict(self._precision_ratio)
        for i, call in enumerate(trace):
            bufs = [self._buffer(trace, bid)
                    for _, bid, _, _, _ in call.operands]
            # panel factorization (getf2) is not level-3: never offloaded,
            # it serializes on the host between the device BLAS calls
            offload = (self.policy != "cpu"
                       and not call.routine.endswith("getf2")
                       and call.n_avg > self.threshold
                       and i not in forced_host)
            # venue replay: a call the live run executed on the pallas
            # venue runs under its routine's calibrated ratio here, and
            # counts — so a live kernel-path run replays to the same
            # kernel_calls the runtime report shows
            if self.kernel_path and offload and call.venue == "pallas":
                self._kmult = self._venue_ratio.get(call.routine, 1.0)
                self.report.kernel_calls += 1
            else:
                self._kmult = 1.0
            # precision replay: a call the live run dispatched split
            # runs under its routine's calibrated split/native ratio
            # and counts — a precision run replays to the same
            # split_calls the runtime report shows
            if self.precision and offload and call.precision:
                self._pmult = self._precision_ratio.get(call.routine, 1.0)
                self.report.split_calls += 1
            else:
                self._pmult = 1.0
            if not offload:
                t = self._host_call(call, bufs)
            elif self.policy == "memcopy":
                t = self._memcopy(call, bufs)
            elif self.policy == "dfu":
                t = (self._dfu(call, bufs) if self.n_devices == 1
                     else self._dfu_multi(call, bufs))
                self._register_output(trace, call)
            elif self.policy == "counter":
                t = self._counter(call, bufs)
            else:                                   # pinned
                t = self._device_kernel(call, bufs)
            self.report.total_s += t
            key = call.routine
            self.report.per_routine_s[key] = (
                self.report.per_routine_s.get(key, 0.0) + t)
            if call.callsite_id:
                self.report.per_site_s[call.callsite_id] = (
                    self.report.per_site_s.get(call.callsite_id, 0.0) + t)
            self.report.device_bytes_peak = max(
                self.report.device_bytes_peak, self.pt.device_bytes_used())
        reuse = self.pt.reuse_report()
        self.report.mean_reuse = reuse.get("mean_reuse", 0.0)
        self.report.max_reuse = reuse.get("max_reuse", 0.0)
        self.report.n_migrated_buffers = int(
            reuse.get("n_migrated_buffers", 0))
        # residency-engine counters, straight off the shared stores
        self.report.evictions = sum(s.evictions for s in self._stores)
        self.report.refetches = sum(s.refetches for s in self._stores)
        self.report.refetched_bytes = sum(s.refetched_bytes
                                          for s in self._stores)
        # fault counters come straight off the recorded events — the
        # injector is deterministic, so live == replay by construction
        ses = self.session or None
        self.report.faults = trace.event_count("fault", session=ses)
        self.report.retries = trace.event_count("retry", session=ses)
        self.report.fallbacks = trace.event_count("fallback", session=ses)
        self.report.quarantines = trace.event_count("quarantine",
                                                    session=ses)
        self.report.recoveries = trace.event_count("recover", session=ses)
        # escalation counters come straight off the recorded events —
        # the residual checks already ran live, so live == replay
        self.report.escalations = trace.event_count("escalate",
                                                    session=ses)
        # solver spans come straight off the recorded events and the
        # per-call solver_id tags — the drivers already ran live, so a
        # LAPACK-tier run replays to its exact per-solver counters
        for ev in trace.events:
            if ev.kind == "solver_begin" and (
                    not self.session or ev.session == self.session):
                slot = self.report.per_solver.setdefault(
                    ev.store.split("#", 1)[0],
                    {"spans": 0, "calls": 0, "panel_calls": 0})
                slot["spans"] += 1
                self.report.solver_spans += 1
        for call in trace:
            if call.solver_id:
                slot = self.report.per_solver.setdefault(
                    call.solver,
                    {"spans": 0, "calls": 0, "panel_calls": 0})
                slot["calls"] += 1
                if call.routine.endswith("getf2"):
                    slot["panel_calls"] += 1
        return self.report

    # convenience: residency of a trace buffer after the run
    def residency(self, bid: int) -> Optional[str]:
        b = self._bufs.get(bid)
        if b is None:
            return None
        if b.fully_on(MemKind.DEVICE):
            return "device"
        if b.fully_on(MemKind.HOST):
            return "host"
        return "mixed"


def replay_trace(trace: Trace, *, spec: HardwareSpec = GH200,
                 policies=POLICIES, threshold: float = 500.0,
                 aligned_alloc: bool = False,
                 evict_lru: bool = False,
                 n_devices: int = 1,
                 device_bytes: Optional[int] = None,
                 evict: str = "lru",
                 kernel_path: bool = False,
                 precision: str = "") -> Dict[str, PolicyReport]:
    """Run one trace under several policies (the paper's Tables 3/5)."""
    out = {}
    for p in policies:
        sim = MemTierSimulator(spec, policy=p, threshold=threshold,
                               aligned_alloc=aligned_alloc,
                               evict_lru=evict_lru, n_devices=n_devices,
                               device_bytes=device_bytes, evict=evict,
                               kernel_path=kernel_path,
                               precision=precision)
        out[p] = sim.run(trace)
    return out
