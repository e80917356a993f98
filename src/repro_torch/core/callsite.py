"""Call-site identity and per-site profiles (paper §3.1, per-site patching).

The port's copy of ``repro/core/callsite.py``.  The paper's tool does not
make one global offload decision: dynamic binary instrumentation patches
each BLAS *call site* individually and profiles it.  This module is the
PyTorch analogue:

* :func:`fingerprint` — a cheap call-site id built from the interception
  entry point (the BLAS routine) plus the first caller frame outside the
  dispatch machinery.  A loop calling ``blas.gemm`` from one line is one
  site; the same gemm shape issued from two places is two sites.
* :class:`CallSiteProfile` — what the runtime learns about one site:
  call count, size (N_avg) distribution, residency hit rate, per-venue
  probe times and — in adaptive mode — the locked decision.
* :class:`CallSiteRegistry` — the per-runtime site table; the analogue of
  the paper's patched-trampoline table.

Frames inside the port's dispatch machinery (``blas.py``, ``runtime.py``,
``intercept.py``, this file) are skipped, so an intercepted
``torch.matmul`` fingerprints to the application line that called it.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
from typing import Dict, Iterator, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
#: dispatch-machinery files whose frames never count as the call site;
#: other trampoline layers add themselves (:func:`register_machinery`)
_MACHINERY = set(
    os.path.join(_HERE, name)
    for name in ("callsite.py", "runtime.py", "blas.py", "intercept.py"))
_MAX_WALK = 16


def register_machinery(path: str) -> None:
    """Mark a module file as dispatch machinery: its frames are skipped
    when fingerprinting call sites, so a patched ``torch.linalg`` call
    fingerprints to the application line, not to the trampoline."""
    _MACHINERY.add(os.path.abspath(path))

UNKNOWN = "<unknown>"

#: execution venues in probe-schedule order: the host path, the generic
#: offload and the hand-written kernel offload (``kernel_path``).  The
#: labels are the reference's; on the card both offload venues compute on
#: the port's kernels.
VENUES = ("host", "xla", "pallas")


def fingerprint(entry: str) -> str:
    """Cheap call-site id: ``entry@file:function:lineno``.

    ``entry`` is the interception entry point (the BLAS routine name).
    The caller frame is the first one outside the dispatch machinery.
    """
    try:
        frame = sys._getframe(1)
    except ValueError:                      # pragma: no cover - no caller
        return f"{entry}@{UNKNOWN}"
    for _ in range(_MAX_WALK):
        if frame is None:
            break
        code = frame.f_code
        if code.co_filename not in _MACHINERY:
            return (f"{entry}@{os.path.basename(code.co_filename)}"
                    f":{code.co_name}:{frame.f_lineno}")
        frame = frame.f_back
    return f"{entry}@{UNKNOWN}"


@dataclasses.dataclass
class CallSiteProfile:
    """Everything the runtime has learned about one BLAS call site."""

    site: str
    calls: int = 0
    flops: float = 0.0
    seconds: float = 0.0
    offloaded: int = 0
    on_host: int = 0
    # size distribution (N_avg per call; locked adaptive calls skip the
    # derivation entirely, so the count can trail ``calls``)
    n_avg_min: float = float("inf")
    n_avg_max: float = 0.0
    n_avg_sum: float = 0.0
    n_avg_count: int = 0
    # residency: operand placements attempted / found already resident
    lookups: int = 0
    hits: int = 0
    # adaptive warmup: per-venue wall-time samples (paper: profile the
    # first N calls on every path, then patch in the fastest)
    host_timed: int = 0
    host_seconds: float = 0.0
    host_best: float = float("inf")
    device_timed: int = 0
    device_seconds: float = 0.0
    device_best: float = float("inf")
    # third venue (kernel_path): probes of the hand-written kernel offload
    kernel_timed: int = 0
    kernel_seconds: float = 0.0
    kernel_best: float = float("inf")
    # completed calls that executed on the pallas venue (subdivides
    # ``offloaded``) and their wall time
    pallas_calls: int = 0
    pallas_seconds: float = 0.0
    # split-precision pseudo-venue: timed probes of the split formulation,
    # the scheme/venue they ran under, and whether any probe missed its
    # error bound — a site that escalated during warmup never locks split
    split_timed: int = 0
    split_seconds: float = 0.0
    split_best: float = float("inf")
    split_scheme: str = ""                 # scheme the probes ran
    split_venue: str = ""                  # venue the probes ran on
    split_bad: bool = False                # a probe escalated
    # completed calls that executed split (subdivides ``offloaded``)
    split_calls: int = 0
    locked: Optional[bool] = None          # the locked offload decision
    locked_venue: str = ""                 # "" until locked (see VENUES)
    locked_precision: str = ""             # locked split scheme (or "")
    locked_why: str = ""
    last_offload: Optional[bool] = None    # decision of the latest call
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def observe(self, n_avg: float, flops: float, seconds: float,
                offload: bool, venue: str = "",
                precision: str = "") -> None:
        """Record one completed call at this site.  ``n_avg <= 0`` means
        "not derived" (the locked adaptive fast path): the call counts,
        the size distribution is left untouched."""
        with self._lock:
            self.calls += 1
            self.flops += flops
            self.seconds += seconds
            if offload:
                self.offloaded += 1
                if venue == "pallas":
                    self.pallas_calls += 1
                    self.pallas_seconds += seconds
                if precision:
                    self.split_calls += 1
            else:
                self.on_host += 1
            self.last_offload = offload
            if n_avg > 0:
                self.n_avg_min = min(self.n_avg_min, n_avg)
                self.n_avg_max = max(self.n_avg_max, n_avg)
                self.n_avg_sum += n_avg
                self.n_avg_count += 1

    def observe_residency(self, hit: bool) -> None:
        """One operand placement attempt at this site found (or missed) a
        resident entry in the runtime's residency store."""
        with self._lock:
            self.lookups += 1
            self.hits += int(hit)

    def observe_probe(self, offload: bool, seconds: float,
                      venue: str = "", precision: str = "") -> None:
        """Record one timed adaptive-warmup probe on one venue.  With no
        ``venue`` given, ``offload`` picks between the two classic
        paths; ``venue="pallas"`` routes to the kernel-venue counters; a
        non-empty ``precision`` routes to the split pseudo-venue counters
        whatever venue the split passes ran on."""
        with self._lock:
            if precision:
                self.split_timed += 1
                self.split_seconds += seconds
                self.split_scheme = precision
                self.split_venue = venue or "xla"
                self.split_best = min(self.split_best, seconds)
            elif venue == "pallas":
                self.kernel_timed += 1
                self.kernel_seconds += seconds
                self.kernel_best = min(self.kernel_best, seconds)
            elif offload:
                self.device_timed += 1
                self.device_seconds += seconds
                self.device_best = min(self.device_best, seconds)
            else:
                self.host_timed += 1
                self.host_seconds += seconds
                self.host_best = min(self.host_best, seconds)

    @property
    def probes_done(self) -> int:
        return (self.host_timed + self.device_timed + self.kernel_timed
                + self.split_timed)

    def probe_path(self) -> bool:
        """Deterministic two-path schedule: even probes run the host
        path, odd probes offload."""
        return self.probes_done % 2 == 1

    def probe_venue(self, venues: int = 2, split: bool = False) -> str:
        """Round-robin warmup schedule over the first ``venues`` entries
        of :data:`VENUES` (``venues=2`` is the classic host/offload
        alternation, ``3`` adds the kernel venue); ``split=True`` appends
        the split-precision pseudo-venue, so precision variants race like
        venues do."""
        order = VENUES[:venues] + (("split",) if split else ())
        return order[self.probes_done % len(order)]

    def lock(self, fallback: Optional[bool] = None) -> bool:
        """Lock the fastest venue (the paper's warmup-then-patch step).

        Compares the *best* sample per venue, not the mean: the first
        probe of a venue may pay one-off costs (a kernel build, the
        first placement), and the minimum is robust to them.  A venue
        with no samples loses by default; with no samples at all the
        threshold ``fallback`` decides.  The split pseudo-venue wins only
        when no probe escalated."""
        with self._lock:
            if self.locked is not None:
                return self.locked
            if self.probes_done == 0:
                self.locked = bool(fallback)
                self.locked_venue = "xla" if self.locked else "host"
                self.locked_why = "no probes; threshold fallback"
                return self.locked
            if (self.split_timed and not self.split_bad
                    and self.split_best < self.device_best
                    and self.split_best < self.host_best
                    and self.split_best < self.kernel_best):
                self.locked = True
                self.locked_venue = self.split_venue or "xla"
                self.locked_precision = self.split_scheme
                self.locked_why = (
                    f"{self.split_scheme} {self.split_best * 1e6:.0f}us vs "
                    f"device {self.device_best * 1e6:.0f}us vs "
                    f"host {self.host_best * 1e6:.0f}us "
                    f"over {self.probes_done} probes")
                return self.locked
            if (self.kernel_timed
                    and self.kernel_best < self.device_best
                    and self.kernel_best < self.host_best):
                self.locked = True
                self.locked_venue = "pallas"
                self.locked_why = (
                    f"pallas {self.kernel_best * 1e6:.0f}us vs "
                    f"device {self.device_best * 1e6:.0f}us vs "
                    f"host {self.host_best * 1e6:.0f}us "
                    f"over {self.probes_done} probes")
                return self.locked
            self.locked = self.device_best < self.host_best
            self.locked_venue = "xla" if self.locked else "host"
            self.locked_why = (f"device {self.device_best * 1e6:.0f}us "
                               f"vs host {self.host_best * 1e6:.0f}us "
                               f"over {self.probes_done} probes")
            return self.locked

    def reset(self, *, samples: bool, kernel: bool, split: bool) -> None:
        """Drop the lock (a reconfiguration invalidated it) and the probe
        samples of the regimes that changed: ``samples`` the host/xla
        ones, ``kernel`` the pallas ones, ``split`` the split ones."""
        with self._lock:
            self.locked = None
            self.locked_why = ""
            self.locked_venue = ""
            self.locked_precision = ""
            if samples:
                self.host_timed = self.device_timed = 0
                self.host_seconds = self.device_seconds = 0.0
                self.host_best = self.device_best = float("inf")
            if kernel:
                self.kernel_timed = 0
                self.kernel_seconds = 0.0
                self.kernel_best = float("inf")
            if split:
                self.split_timed = 0
                self.split_seconds = 0.0
                self.split_best = float("inf")
                self.split_scheme = ""
                self.split_venue = ""
                self.split_bad = False

    @property
    def n_avg_mean(self) -> float:
        return (self.n_avg_sum / self.n_avg_count
                if self.n_avg_count else 0.0)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def decision_label(self) -> str:
        """Human label for the report table."""
        if self.locked is not None:
            tag = f"~{self.locked_precision}" if self.locked_precision else ""
            if self.locked_venue == "pallas":
                return "pallas*" + tag
            return ("offload*" if self.locked else "host*") + tag
        if self.last_offload is None:
            return "-"
        return "offload" if self.last_offload else "host"


class CallSiteRegistry:
    """Site id -> profile; the runtime's patched-call-site table.
    Creation is lock-guarded so two threads hitting a new site for the
    first time agree on one profile."""

    def __init__(self) -> None:
        self._sites: Dict[str, CallSiteProfile] = {}
        self._lock = threading.Lock()

    def profile(self, site: str) -> CallSiteProfile:
        prof = self._sites.get(site)
        if prof is None:
            with self._lock:
                prof = self._sites.get(site)
                if prof is None:
                    prof = self._sites[site] = CallSiteProfile(site)
        return prof

    def get(self, site: str) -> Optional[CallSiteProfile]:
        return self._sites.get(site)

    def top_by_flops(self, n: int = 8) -> List[CallSiteProfile]:
        return sorted(self._sites.values(), key=lambda p: -p.flops)[:n]

    def __len__(self) -> int:
        return len(self._sites)

    def __iter__(self) -> Iterator[CallSiteProfile]:
        return iter(self._sites.values())

    def __contains__(self, site: str) -> bool:
        return site in self._sites
