"""BLAS call traces (paper §3: what the interceptor sees).

The schema is the one of ``repro/core/trace.py``, field for field, so a
trace dumped by the port loads with ``repro.core.trace.Trace.load`` and
replays through the reference memtier simulator.

A trace is the sequence of level-3 BLAS invocations an application makes,
with operand identities (so reuse is visible) but no array payloads. The
interception layer records traces; the memtier simulator replays them under
different data-movement policies with calibrated hardware constants — the
methodology behind Tables 3 and 5 of the paper.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.residency import ResidencyEvent

# FLOP multipliers: complex arithmetic costs 4 real mul + 4 real add per
# complex multiply-add -> 4x the real FLOP count at equal dimensions.
_COMPLEX = {"c": 4.0, "z": 4.0, "s": 1.0, "d": 1.0}
_ELEM = {"s": 4, "d": 8, "c": 8, "z": 16}


@dataclasses.dataclass(frozen=True)
class BlasCall:
    """One level-3 BLAS invocation.

    ``operands`` maps role -> (buffer_id, bytes, reads_per_elem, written):
    the per-element device read multiplicity drives the access-counter
    model, ``written`` marks output operands (matrix C, or B for trsm/trmm).

    ``devices`` records the multi-device tile schedule: one device-tier
    index per tile when the runtime sharded the call, empty for
    single-device execution (older traces load with the empty default).

    ``callsite_id`` is the call-site fingerprint of
    :mod:`repro_torch.core.callsite` (``routine@file:function:lineno``) — the
    per-site identity the paper's DBI patching keys on; ``seconds`` is
    the runtime's measured per-call wall time (dispatch/submission time
    in async mode, device wall time under ``SCILIB_SYNC=1``).  Both
    default empty/zero so older traces load unchanged.

    ``out_buf``/``out_nbytes`` identify the call's *output* buffer when
    it is a fresh allocation (no written operand to alias).  Offloaded
    outputs are born device-resident and occupy residency-store bytes
    in the live runtime, so the simulator must account them too or its
    cap-eviction replay drifts from the live run.  Default -1/0 keeps
    older traces loading unchanged (and replaying exactly as before).
    """

    routine: str                     # e.g. "zgemm", "dtrsm"
    m: int
    n: int
    k: int                           # 0 where not applicable
    operands: Tuple[Tuple[str, int, int, float, bool], ...]
    # each: (role, buffer_id, nbytes, reads_per_elem, written)
    batch: int = 1
    devices: Tuple[int, ...] = ()    # device tier per scheduled tile
    callsite_id: str = ""            # per-site fingerprint (may be "")
    seconds: float = 0.0             # measured per-call wall time
    out_buf: int = -1                # fresh-output buffer id (or -1)
    out_nbytes: int = 0              # its size (0 when out_buf is -1)
    # execution venue ("host"/"xla"/"pallas"); recorded only by
    # kernel-path runs (OffloadConfig.kernel_path) so default-off trace
    # dumps stay byte-identical to pre-venue traces
    venue: str = ""
    # split-precision scheme the call dispatched under ("split2"/
    # "split3"); recorded only by SCILIB_PRECISION runs, same
    # byte-stability rule as ``venue``.  Escalated calls keep the
    # attempted scheme here — the ``escalate`` trace event carries the
    # rest of the story.
    precision: str = ""
    # the solver span this call ran inside ("<solver>#<seq>", e.g.
    # "getrf#0"); stamped only by runs driving the LAPACK solver tier
    # (repro.solvers), same byte-stability rule as ``venue``
    solver_id: str = ""

    # ------------------------------------------------------------------ #
    @property
    def prec_prefix(self) -> str:
        """The BLAS precision prefix of the routine (s/d/c/z) — distinct
        from ``precision``, the split-emulation scheme."""
        return self.routine[0]

    @property
    def flops(self) -> float:
        """Real-FLOP count (paper's convention for speedup accounting)."""
        mult = _COMPLEX[self.prec_prefix] * self.batch
        base = self.routine[1:]
        m, n, k = self.m, self.n, self.k
        if base == "gemm":
            return mult * 2.0 * m * n * k
        if base == "gemv":       # level-2 matrix-vector (intercepted)
            return mult * 2.0 * m * n
        if base in ("trsm", "trmm"):
            return mult * 1.0 * m * m * n  # side='L'; side='R' callers swap
        if base in ("syrk", "herk"):
            return mult * 1.0 * n * n * k
        if base in ("syr2k", "her2k"):
            return mult * 2.0 * n * n * k
        if base in ("symm", "hemm"):
            return mult * 2.0 * m * m * n
        if base == "getf2":       # unblocked panel LU (rank-1 updates)
            return mult * 1.0 * m * n * n
        raise ValueError(f"unknown routine {self.routine}")

    @property
    def bytes_touched(self) -> int:
        return self.batch * sum(nb for _, _, nb, _, _ in self.operands)

    @property
    def n_avg(self) -> float:
        """Routine-dependent mean dimension (paper §3.3)."""
        m, n, k = max(1, self.m), max(1, self.n), max(1, self.k)
        base = self.routine[1:]
        if base == "gemm":
            return float((m * n * k) ** (1.0 / 3.0))
        if base in ("trsm", "trmm", "symm", "hemm"):
            return float((m * m * n) ** (1.0 / 3.0))
        if base in ("syrk", "herk", "syr2k", "her2k"):
            return float((n * n * k) ** (1.0 / 3.0))
        return float((m * n * max(k, 1)) ** (1.0 / 3.0))

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        if not self.venue:           # keep default-off dumps byte-stable
            del d["venue"]
        if not self.precision:
            del d["precision"]
        if not self.solver_id:
            del d["solver_id"]
        return d

    @property
    def solver(self) -> str:
        """The solver name of the span this call ran inside ("" when
        the call was not part of a solver span)."""
        return self.solver_id.split("#", 1)[0] if self.solver_id else ""


class Trace:
    """Append-only BLAS trace with named buffer registry.

    ``events`` carries the residency history of the recording run —
    ``place``/``hit``/``evict``/``refetch`` transitions of the runtime's
    residency stores (:mod:`repro_torch.core.residency`), each stamped with
    the call index it interleaves at.  A replay of the same trace under
    the same cap and eviction policy can therefore be checked
    count-for-count against what the live run actually did.  Fault
    tolerance reuses the same channel: ``fault``/``retry``/``fallback``/
    ``quarantine``/``recover`` events (:mod:`repro_torch.core.faults`)
    record what actually went wrong and where the run degraded, so a
    faulted trace replays to the exact live fallback/retry counters.
    Each event carries the session id of a named (multi-tenant) session,
    and each call the tiers its tiles ran on (``BlasCall.devices``).
    """

    def __init__(self) -> None:
        self.calls: List[BlasCall] = []
        self.buffer_sizes: Dict[int, int] = {}
        self.buffer_names: Dict[int, str] = {}
        self.events: List[ResidencyEvent] = []
        self._next_buf = 1
        # guards append paths only: a trace may be shared by several
        # threads adopting one session (Session.scope); readers iterate
        # snapshots after the run drains.
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def record_event(self, kind: str, store: str, nbytes: int,
                     session: str = "") -> None:
        """Append one residency transition, stamped at the current call
        position (the runtime's residency stores point here) and the
        owning session id (empty for single-tenant runs)."""
        with self._lock:
            self.events.append(ResidencyEvent(kind=kind, store=store,
                                              nbytes=int(nbytes),
                                              call_index=len(self.calls),
                                              session=session))

    def event_count(self, kind: str, session: Optional[str] = None) -> int:
        return sum(1 for e in self.events if e.kind == kind
                   and (session is None or e.session == session))

    def event_bytes(self, kind: str, session: Optional[str] = None) -> int:
        return sum(e.nbytes for e in self.events if e.kind == kind
                   and (session is None or e.session == session))

    # ------------------------------------------------------------------ #
    def new_buffer(self, nbytes: int, name: str = "") -> int:
        with self._lock:
            bid = self._next_buf
            self._next_buf += 1
            self.buffer_sizes[bid] = int(nbytes)
            self.buffer_names[bid] = name or f"buf{bid}"
            return bid

    def gemm(self, prec: str, m: int, n: int, k: int,
             a: int, b: int, c: int, batch: int = 1,
             site: str = "", solver: str = "") -> None:
        el = _ELEM[prec]
        self.calls.append(BlasCall(
            routine=f"{prec}gemm", m=m, n=n, k=k, batch=batch,
            operands=(
                ("A", a, m * k * el, float(n), False),
                ("B", b, k * n * el, float(m), False),
                ("C", c, m * n * el, 1.0, True),
            ), callsite_id=site, solver_id=solver))

    def trsm(self, prec: str, m: int, n: int,
             a: int, b: int, batch: int = 1, site: str = "",
             solver: str = "") -> None:
        el = _ELEM[prec]
        self.calls.append(BlasCall(
            routine=f"{prec}trsm", m=m, n=n, k=0, batch=batch,
            operands=(
                ("A", a, m * m * el, float(n), False),
                ("B", b, m * n * el, float(m), True),
            ), callsite_id=site, solver_id=solver))

    def syrk(self, prec: str, n: int, k: int,
             a: int, c: int, batch: int = 1, site: str = "") -> None:
        el = _ELEM[prec]
        self.calls.append(BlasCall(
            routine=f"{prec}syrk", m=n, n=n, k=k, batch=batch,
            operands=(
                ("A", a, n * k * el, float(n), False),
                ("C", c, n * n * el, 1.0, True),
            ), callsite_id=site))

    def panel(self, prec: str, m: int, nb: int, a: int,
              solver: str = "") -> None:
        """Unblocked LU panel factorization (getf2) — host-only work."""
        el = _ELEM[prec]
        self.calls.append(BlasCall(
            routine=f"{prec}getf2", m=m, n=nb, k=0,
            operands=(("P", a, m * nb * el, float(nb), True),),
            solver_id=solver))

    def symm(self, prec: str, m: int, n: int,
             a: int, b: int, c: int, batch: int = 1) -> None:
        el = _ELEM[prec]
        self.calls.append(BlasCall(
            routine=f"{prec}symm", m=m, n=n, k=0, batch=batch,
            operands=(
                ("A", a, m * m * el, float(n), False),
                ("B", b, m * n * el, float(m), False),
                ("C", c, m * n * el, 1.0, True),
            )))

    # ------------------------------------------------------------------ #
    def __iter__(self) -> Iterator[BlasCall]:
        return iter(self.calls)

    def __len__(self) -> int:
        return len(self.calls)

    @property
    def total_flops(self) -> float:
        return sum(c.flops for c in self.calls)

    def dump(self, path: str) -> None:
        """Write the trace atomically: serialize to a sibling temp file,
        fsync, then rename over ``path`` — a crash mid-dump can never
        leave a truncated trace where a valid one (or nothing) should
        be, and a reader racing the dump sees old-or-new, not garbage."""
        payload = {
            "buffers": {str(k): [v, self.buffer_names[k]]
                        for k, v in self.buffer_sizes.items()},
            "calls": [c.to_json() for c in self.calls],
        }
        if self.events:
            payload["events"] = [e.to_json() for e in self.events]
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            raw = json.load(f)
        t = cls()
        for k, (size, name) in raw["buffers"].items():
            t.buffer_sizes[int(k)] = size
            t.buffer_names[int(k)] = name
            t._next_buf = max(t._next_buf, int(k) + 1)
        for c in raw["calls"]:
            c["operands"] = tuple(tuple(o) for o in c["operands"])
            if "devices" in c:
                c["devices"] = tuple(c["devices"])
            t.calls.append(BlasCall(**c))
        for e in raw.get("events", ()):
            t.events.append(ResidencyEvent(**e))
        return t
