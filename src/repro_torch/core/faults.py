"""Fault model for the offload runtime: errors, injection, retry, breaker.

The port's copy of ``repro/core/faults.py``.  The source tool (arxiv
2501.00279) is an ``LD_PRELOAD`` interposer on an unmodified binary —
its one hard obligation is *transparency*: whatever goes wrong on the
accelerator side, the application must still get the answer the
unmodified binary would have computed.  A transfer that faults, a kernel
that aborts, a device that wedges — none of those may surface as a crash
in application code that never asked to be offloaded.  The correct
degraded behaviour is always "run it on the host".

This module is the vocabulary the runtime uses to deliver that:

* a **typed exception hierarchy** — :class:`OffloadError` with
  transient-vs-permanent classification (:class:`TransferError` and
  :class:`KernelError` are transient and retried;
  :class:`DeviceOOMError` is permanent and falls straight back to the
  host path).  ``classify()`` wraps raw backend exceptions
  (``RuntimeError``, ``MemoryError``...) into the hierarchy at the
  guard boundaries; unrecognized exception types pass through unwrapped
  so genuine bugs keep their tracebacks.
* a **deterministic seeded fault injector** — :class:`FaultInjector`,
  configured from the ``SCILIB_FAULTS`` spec grammar::

      transfer:p=0.05,device=1,seed=7;kernel:nth=13

  Rules are ``kind:param=value,...`` joined by ``;``.  Kinds:
  ``transfer`` / ``kernel`` (transient faults at the matching guard),
  ``oom`` (a permanent :class:`DeviceOOMError` at transfer guards) and
  ``latency`` (a sleep of ``ms`` milliseconds — a spike, not an error).
  Params: ``p`` (per-check fire probability), ``nth`` (fire every nth
  applicable check), ``device`` (restrict to one device index),
  ``seed`` (per-rule ``random.Random``), ``ms`` (latency duration).
  Faults fire at the *entry* of the real call sites — before any state
  mutates — so a fault absorbed by a retry is a perfect no-op: every
  residency counter, placement and trace event of the run is
  bit-identical to the unfaulted run.
* a **retry policy** — :class:`RetryPolicy`, configurable attempts with
  exponential backoff, applied by the runtime to transient classes only.
* a **per-device circuit breaker** — :class:`HealthTracker`.  Each
  device tier carries a consecutive-failure count (one count per
  *exhausted* unit, i.e. after retries, not per attempt); reaching the
  threshold trips the device to quarantined (``open``).  After a
  cooldown the device turns ``half-open``: it is schedulable again and
  the first unit that touches it is the probe — success closes the
  breaker (a *recover*), failure re-opens it for another cooldown.
  The tracker is clock-injectable for deterministic tests.

**Where the port departs from the reference's ``classify``.**  PyTorch
raises ``RuntimeError`` for far more than device faults, and on the card
an absorbed error is a quiet host fallback, so ``classify`` returns None
(the error propagates unwrapped) for:

* :class:`repro_torch.kernels.compat.KernelBuildError` (``nvcc``
  failed or is missing) and
  :class:`~repro_torch.kernels.compat.KernelLaunchError` (a launch entry
  point returned a CUDA error or could not make its TMA descriptors):
  the port is broken, not the device, and a retry or a fallback would
  hide it;
* CUDA's sticky errors — ``torch.AcceleratorError`` where this torch
  has it, or a message naming an illegal memory access, an unspecified
  launch failure, a misaligned address, an illegal instruction or a
  device-side assert.  After one of these the context is lost: a retry
  cannot succeed and the host path cannot read its device operands.

``torch.cuda.OutOfMemoryError`` maps to :class:`DeviceOOMError` by type
(the reference matches the message).  Everything else keeps the
reference's mapping.  A shape or dtype mismatch inside a compute closure
is a ``RuntimeError`` in PyTorch (a ``TypeError`` in JAX), so it is
classified as a kernel fault; the host fallback then reruns the same
closure unguarded and the bug surfaces there, with its own traceback.

The module imports only the standard library, ``torch`` and the kernel
builder's error types, so every layer — memspace, config validation,
the runtime — can import it without cycles.
"""
from __future__ import annotations

import dataclasses
import random
import re
import threading
import time
from typing import Callable, Dict, List, NoReturn, Optional, Tuple

import torch

from repro_torch.kernels.compat import KernelBuildError, KernelLaunchError

__all__ = ["OffloadError", "TransferError", "DeviceOOMError",
           "KernelError", "classify", "raise_typed", "FaultRule", "parse_spec",
           "FaultInjector", "RetryPolicy", "DeviceHealth",
           "HealthTracker", "CLOSED", "OPEN", "HALF_OPEN",
           "FAULT_EVENT_KINDS"]

#: trace-event kinds the failure paths emit (the residency-event channel
#: carries them; the memtier simulator replays them)
FAULT_EVENT_KINDS = ("fault", "retry", "fallback", "quarantine", "recover")


# --------------------------------------------------------------------- #
# the typed exception hierarchy                                          #
# --------------------------------------------------------------------- #
class OffloadError(RuntimeError):
    """Base of every offload-path failure the runtime can absorb.

    ``transient`` decides retry eligibility; ``kind`` labels the trace
    events and the decision IR's ``why``; ``device`` is the device-tier
    index the failure is attributed to (None when the site has no
    per-device identity, e.g. the whole-call logical device put);
    ``injected`` marks synthetic faults from the injector.
    """

    transient = False
    kind = "offload"

    def __init__(self, msg: str, *, device: Optional[int] = None,
                 nbytes: int = 0, injected: bool = False):
        super().__init__(msg)
        self.device = device
        self.nbytes = int(nbytes)
        self.injected = injected


class TransferError(OffloadError):
    """A host<->device movement failed (transient: link hiccup, a
    transient allocation failure, an interrupted DMA)."""

    transient = True
    kind = "transfer"


class DeviceOOMError(TransferError):
    """The device memory is exhausted.  Permanent: retrying the same
    allocation immediately cannot succeed — fall back to the host."""

    transient = False
    kind = "oom"


class KernelError(OffloadError):
    """Device compute failed after its operands were placed."""

    transient = True
    kind = "kernel"


_OOM_RE = re.compile(r"RESOURCE_EXHAUSTED|out of memory|OOM",
                     re.IGNORECASE)

#: raw exception types the guards are allowed to absorb; anything else
#: (TypeError, ValueError...) is a bug in our stack, not a device fault,
#: and must keep its traceback.
_ABSORBABLE = (RuntimeError, MemoryError, OSError)

#: errors of the port itself, never of the device: a kernel that did not
#: build or could not be launched (kernels/compat.py)
_PORT_ERRORS = (KernelBuildError, KernelLaunchError)

#: CUDA's sticky errors: the context is lost after one, so neither a
#: retry nor the host path (which reads device operands) can succeed
_STICKY_RE = re.compile(r"illegal memory access|unspecified launch failure"
                        r"|misaligned address|illegal instruction"
                        r"|device-side assert", re.IGNORECASE)
_STICKY_TYPES = tuple(t for t in (getattr(torch, "AcceleratorError", None),)
                      if t is not None)


def _sticky(exc: BaseException) -> bool:
    """Is ``exc`` one of CUDA's sticky errors (a lost context)?"""
    return (isinstance(exc, _STICKY_TYPES)
            or bool(_STICKY_RE.search(str(exc))))


def classify(site: str, exc: BaseException, *,
             device: Optional[int] = None,
             nbytes: int = 0) -> Optional[OffloadError]:
    """Map a raw exception at a guard site to the typed hierarchy.

    ``site`` is ``"transfer"`` or ``"kernel"``.  Returns the exception
    unchanged when it is already typed, a wrapped :class:`OffloadError`
    for absorbable backend errors, and None for everything else — the
    caller re-raises those unwrapped.  None also for the port's own
    build and launch errors and for CUDA's sticky errors (see the module
    docstring)."""
    if isinstance(exc, OffloadError):
        return exc
    if (not isinstance(exc, _ABSORBABLE) or isinstance(exc, _PORT_ERRORS)
            or _sticky(exc)):
        return None
    msg = f"{type(exc).__name__}: {exc}"
    if (isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError))
            or _OOM_RE.search(str(exc))):
        return DeviceOOMError(msg, device=device, nbytes=nbytes)
    cls = KernelError if site == "kernel" else TransferError
    return cls(msg, device=device, nbytes=nbytes)


def raise_typed(site: str, exc: BaseException, *,
                device: Optional[int] = None, nbytes: int = 0) -> NoReturn:
    """Raise ``exc`` as :func:`classify` types it: the typed error
    chained to ``exc``, or ``exc`` itself when it is typed already or is
    not the device's to absorb.

    Call it from the ``except`` clause that caught ``exc``, and keep no
    other local reference to the error: its traceback holds the frames
    it passes through, and a frame that also held the error would make a
    cycle keeping the failing unit's operands (HBM on the card) alive
    until the collector ran.  This frame drops its own on the way out."""
    err = classify(site, exc, device=device, nbytes=nbytes)
    try:
        if err is None or err is exc:
            raise exc
        raise err from exc
    finally:
        err = exc = None


# --------------------------------------------------------------------- #
# the fault-injection spec                                               #
# --------------------------------------------------------------------- #
_KINDS = ("transfer", "kernel", "oom", "latency")

#: guard site -> rule kinds consulted there.  ``oom`` and ``latency``
#: piggyback on transfer checks (allocation happens at transfer time);
#: latency spikes additionally apply to kernel launches.
_SITE_KINDS = {"transfer": ("transfer", "oom", "latency"),
               "kernel": ("kernel", "latency")}


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One parsed rule of a ``SCILIB_FAULTS`` spec."""

    kind: str                      # transfer | kernel | oom | latency
    p: float = 0.0                 # per-check fire probability
    nth: int = 0                   # fire every nth applicable check
    device: Optional[int] = None   # restrict to one device index
    seed: int = 0                  # per-rule RNG seed (determinism)
    ms: float = 1.0                # latency spike duration


def parse_spec(spec: str) -> Tuple[FaultRule, ...]:
    """Parse ``"transfer:p=0.05,device=1,seed=7;kernel:nth=13"``.

    Raises ``ValueError`` with a pointed message on any malformed
    fragment; an empty/whitespace spec parses to no rules.
    """
    rules: List[FaultRule] = []
    for frag in spec.split(";"):
        frag = frag.strip()
        if not frag:
            continue
        kind, _, params = frag.partition(":")
        kind = kind.strip().lower()
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in "
                             f"{frag!r}; choose from {sorted(_KINDS)}")
        kw: Dict[str, object] = {}
        for item in filter(None, (s.strip() for s in params.split(","))):
            name, sep, raw = item.partition("=")
            name = name.strip().lower()
            if not sep:
                raise ValueError(f"fault param {item!r} is not "
                                 f"name=value (in {frag!r})")
            try:
                if name == "p":
                    val = float(raw)
                    if not 0.0 <= val <= 1.0:
                        raise ValueError
                elif name == "nth":
                    val = int(raw)
                    if val < 1:
                        raise ValueError
                elif name == "device":
                    val = int(raw)
                    if val < 0:
                        raise ValueError
                elif name == "seed":
                    val = int(raw)
                elif name == "ms":
                    val = float(raw)
                    if val < 0:
                        raise ValueError
                else:
                    raise ValueError(
                        f"unknown fault param {name!r} in {frag!r}; "
                        f"choose from p, nth, device, seed, ms")
            except ValueError as exc:
                if exc.args and "fault param" in str(exc):
                    raise
                raise ValueError(f"bad value {raw!r} for fault param "
                                 f"{name!r} in {frag!r}") from None
            kw[name] = val
        if "p" not in kw and "nth" not in kw and kind != "latency":
            raise ValueError(f"fault rule {frag!r} needs p= or nth= "
                             f"to ever fire")
        rules.append(FaultRule(kind=kind, **kw))   # type: ignore[arg-type]
    return tuple(rules)


_INJECTED_ERRORS = {"transfer": TransferError, "oom": DeviceOOMError,
                    "kernel": KernelError}


class FaultInjector:
    """Deterministic seeded fault injection at the real guard sites.

    One independent ``random.Random(seed)`` per rule, plus a per-rule
    applicable-check counter for ``nth`` — the fire pattern is a pure
    function of the rule and the sequence of checks it sees, so two
    identically-configured runs (or a run and its CI re-run) inject the
    exact same faults.
    """

    def __init__(self, rules: Tuple[FaultRule, ...]):
        self.rules = tuple(rules)
        self._rngs = [random.Random(r.seed) for r in self.rules]
        self._counts = [0] * len(self.rules)
        #: injected faults by kind (latency spikes count too)
        self.injected: Dict[str, int] = {k: 0 for k in _KINDS}
        # the counter/RNG walk is the determinism contract; keep it
        # atomic per check so shared injectors stay sequence-exact
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str) -> Optional["FaultInjector"]:
        """An injector for a spec string, or None when it is empty."""
        rules = parse_spec(spec or "")
        return cls(rules) if rules else None

    def total_injected(self) -> int:
        return sum(self.injected.values())

    def check(self, site: str, *, device: Optional[int] = None,
              nbytes: int = 0) -> None:
        """Consult every applicable rule at one guard site; raises the
        mapped :class:`OffloadError` (or sleeps, for latency) when a
        rule fires.  Called *before* the guarded operation touches any
        state, so an absorbed fault perturbs nothing.

        The rule walk (counters, RNG draws, injected tallies) runs under
        the injector lock so concurrent checks interleave as whole
        checks; the latency sleep and the raise happen outside it."""
        sleep_s = 0.0
        fired: Optional[FaultRule] = None
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.kind not in _SITE_KINDS[site]:
                    continue
                if rule.device is not None and rule.device != device:
                    continue
                fire = False
                if rule.nth:
                    self._counts[i] += 1
                    fire = self._counts[i] % rule.nth == 0
                if not fire and rule.p:
                    fire = self._rngs[i].random() < rule.p
                if not fire:
                    continue
                self.injected[rule.kind] += 1
                if rule.kind == "latency":
                    sleep_s += rule.ms / 1000.0
                    continue
                fired = rule
                break
        if sleep_s > 0:
            time.sleep(sleep_s)
        if fired is not None:
            err = _INJECTED_ERRORS[fired.kind]
            raise err(f"injected {fired.kind} fault at {site} "
                      f"(device={device}, nbytes={nbytes})",
                      device=device, nbytes=nbytes, injected=True)


# --------------------------------------------------------------------- #
# retry with exponential backoff                                         #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` extra tries after the first failure, sleeping
    ``backoff_ms * 2**n`` before retry ``n`` (n = 0, 1, ...).  Applied
    by the runtime to transient fault classes only."""

    attempts: int = 2
    backoff_ms: float = 1.0

    def delay_s(self, attempt: int) -> float:
        """Backoff before the given 0-based retry attempt."""
        return (self.backoff_ms / 1000.0) * (2.0 ** attempt)

    def sleep(self, attempt: int) -> None:
        d = self.delay_s(attempt)
        if d > 0:
            time.sleep(d)


# --------------------------------------------------------------------- #
# per-device health / circuit breaker                                    #
# --------------------------------------------------------------------- #
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


@dataclasses.dataclass
class DeviceHealth:
    """Breaker state of one device tier."""

    state: str = CLOSED
    consecutive: int = 0       # consecutive exhausted-unit failures
    failures: int = 0          # total exhausted-unit failures
    quarantines: int = 0       # times tripped open (incl. re-opens)
    opened_at: float = 0.0     # clock() at the last trip


class HealthTracker:
    """Per-device consecutive-failure circuit breaker.

    State machine (per device)::

        closed --threshold consecutive failures--> open (quarantined)
        open   --cooldown elapses--------------->  half-open (probe)
        half-open --unit succeeds--------------->  closed   (recover)
        half-open --unit fails------------------>  open     (re-trip)

    ``threshold=0`` disables the breaker entirely: every device is
    always usable and failures only accumulate totals.  ``on_quarantine``
    / ``on_recover`` fire on the closed->open and ->closed transitions
    (the runtime invalidates block stores and emits trace events there).
    """

    def __init__(self, n_devices: int, *, threshold: int = 3,
                 cooldown_ms: float = 1000.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_quarantine: Optional[Callable[[int], None]] = None,
                 on_recover: Optional[Callable[[int], None]] = None):
        self.n_devices = max(1, int(n_devices))
        self.threshold = int(threshold)
        self.cooldown_ms = float(cooldown_ms)
        self.clock = clock
        self.on_quarantine = on_quarantine
        self.on_recover = on_recover
        self._devs = [DeviceHealth() for _ in range(self.n_devices)]
        self._n_not_closed = 0
        # breaker transitions are multi-field updates; the RLock keeps
        # them atomic (reentrant: usable_count -> usable).  Lock order:
        # acquired after the runtime lock, before any store lock.
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ #
    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def device(self, d: int) -> DeviceHealth:
        return self._devs[d]

    def devices(self) -> List[DeviceHealth]:
        return list(self._devs)

    def reconfigure(self, *, threshold: int,
                    cooldown_ms: float) -> None:
        """Update the knobs in place, keeping per-device state (live
        ``Session.reconfigure``).  Disabling re-admits every device."""
        with self._lock:
            self.threshold = int(threshold)
            self.cooldown_ms = float(cooldown_ms)
            if not self.enabled:
                for h in self._devs:
                    h.state = CLOSED
                    h.consecutive = 0
                self._n_not_closed = 0

    # ------------------------------------------------------------------ #
    def usable(self, d: int) -> bool:
        """May the scheduler send work to this device now?  An open
        device whose cooldown elapsed turns half-open here (lazily) and
        becomes schedulable — the next unit on it is the probe."""
        with self._lock:
            h = self._devs[d]
            if not self.enabled or h.state == CLOSED:
                return True
            if (h.state == OPEN
                    and (self.clock() - h.opened_at) * 1000.0
                    >= self.cooldown_ms):
                h.state = HALF_OPEN
            return h.state != OPEN

    def usable_count(self) -> int:
        with self._lock:
            if not self.enabled or self._n_not_closed == 0:
                return self.n_devices
            return sum(1 for d in range(self.n_devices) if self.usable(d))

    def usable_devices(self) -> List[int]:
        return [d for d in range(self.n_devices) if self.usable(d)]

    def any_usable(self) -> bool:
        return self.usable_count() > 0

    # ------------------------------------------------------------------ #
    def ok(self, d: int) -> None:
        """One unit succeeded on ``d``: reset the consecutive count; a
        half-open (or open) device closes — the recover transition."""
        with self._lock:
            h = self._devs[d]
            if h.state == CLOSED:
                if h.consecutive:
                    h.consecutive = 0
                return
            h.consecutive = 0
            h.state = CLOSED
            self._n_not_closed -= 1
            recovered = self.on_recover is not None
        if recovered:
            self.on_recover(d)

    def failure(self, d: int) -> bool:
        """One unit *exhausted* its retries (or failed permanently) on
        ``d``.  Returns True when this failure trips (or re-trips) the
        breaker."""
        with self._lock:
            h = self._devs[d]
            h.failures += 1
            h.consecutive += 1
            if not self.enabled:
                return False
            trip = (h.state == HALF_OPEN
                    or (h.state == CLOSED
                        and h.consecutive >= self.threshold))
            if not trip:
                return False
            if h.state == CLOSED:
                self._n_not_closed += 1
            h.state = OPEN
            h.opened_at = self.clock()
            h.quarantines += 1
            quarantined = self.on_quarantine is not None
        if quarantined:
            self.on_quarantine(d)
        return True
