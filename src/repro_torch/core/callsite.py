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
  call count, size (N_avg) distribution, residency hit rate, wall time.
* :class:`CallSiteRegistry` — the per-runtime site table; the analogue of
  the paper's patched-trampoline table.

Frames inside the port's dispatch machinery (``blas.py``, ``runtime.py``,
``intercept.py``, this file) are skipped, so an intercepted
``torch.matmul`` fingerprints to the application line that called it.
The adaptive per-site probe-and-lock mode of the reference
(``OffloadConfig.adaptive``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
from typing import Dict, Iterator, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
#: dispatch-machinery files whose frames never count as the call site.
_MACHINERY = set(
    os.path.join(_HERE, name)
    for name in ("callsite.py", "runtime.py", "blas.py", "intercept.py"))
_MAX_WALK = 16

UNKNOWN = "<unknown>"


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
    # size distribution (N_avg per call)
    n_avg_min: float = float("inf")
    n_avg_max: float = 0.0
    n_avg_sum: float = 0.0
    n_avg_count: int = 0
    # residency: operand placements attempted / found already resident
    lookups: int = 0
    hits: int = 0
    last_offload: Optional[bool] = None    # decision of the latest call
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def observe(self, n_avg: float, flops: float, seconds: float,
                offload: bool) -> None:
        """Record one completed call at this site."""
        with self._lock:
            self.calls += 1
            self.flops += flops
            self.seconds += seconds
            if offload:
                self.offloaded += 1
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

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def decision_label(self) -> str:
        """Human label for the report table."""
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

    def top_by_flops(self, n: int = 8) -> List[CallSiteProfile]:
        return sorted(self._sites.values(), key=lambda p: -p.flops)[:n]

    def __len__(self) -> int:
        return len(self._sites)

    def __iter__(self) -> Iterator[CallSiteProfile]:
        return iter(self._sites.values())

    def __contains__(self, site: str) -> bool:
        return site in self._sites
