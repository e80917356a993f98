"""First-class offload sessions: a runtime you hold, not a process global.

The port's counterpart of ``repro/core/session.py``.  A :class:`Session`
owns the offload stack of one workload:

* its :class:`~repro_torch.core.runtime.OffloadRuntime` (placement
  registry, dispatch pipeline, statistics, trace) on one device,
* the installed interceptors (``torch.matmul``/``@``/``mm``/``bmm``/
  ``mv``/``dot``/``einsum``/``tensordot`` trampolines, patched while at
  least one intercepting session is open, refcounted), and with
  ``config.lapack`` the solver trampolines of
  :mod:`repro_torch.solvers.intercept` (``torch.linalg.solve`` and the
  rest, refcounted the same way),
* its :class:`~repro_torch.core.config.OffloadConfig`.

A session runs on the card (``cuda:0``) unless the caller asks for the
CPU with ``device="cpu"``, which runs the simulated-tier mode; with no
CUDA and no ``device="cpu"`` it raises instead of falling back.

Sessions **nest via a stack**: the innermost open session's runtime is
the active dispatch target, and closing it restores the outer one:

    import repro_torch

    with repro_torch.session(OffloadConfig.load("tuned.json")) as s:
        ...                      # dispatched under the tuned config
        print(s.report())

An ``atexit`` hook dumps the recorded trace of any session still open at
interpreter shutdown to its ``config.trace_path``.  The legacy
``install()``/``uninstall()`` shims (:mod:`repro_torch.core.intercept`,
:mod:`repro_torch.core.runtime`) open and close implicit sessions on one
shared stack (:func:`open_legacy`, :func:`close_legacy`).
The last open session's close frees the solver tier's captured LU panels
on the card (:func:`repro_torch.core.lapack.release_graphs`).

Sessions are context-local: a worker thread does not inherit the
sessions its parent opened.  ``with s.scope():`` adopts an open session
in the current thread, and several threads may scope one session at once
(its runtime serializes their calls).  Concurrent sessions may share one
device budget through a
:class:`~repro_torch.core.residency.SharedDevicePool` (``pool=``, or
``pool_bytes``/``pool_quota`` in the config).  Every worker launches on
the current (default) stream.
"""
from __future__ import annotations

import atexit
import contextlib
import threading
from contextvars import ContextVar
from typing import List, Optional, Tuple

from repro_torch.core import memspace
from repro_torch.core.config import OffloadConfig

__all__ = ["Session", "session", "active_session"]

#: innermost-last stack of open sessions (context-local, immutable tuple)
_STACK: ContextVar[Tuple["Session", ...]] = (
    ContextVar("scilib_torch_session_stack", default=()))

#: all open sessions process-wide, for the atexit trace-dump fallback
_OPEN: List["Session"] = []
_OPEN_LOCK = threading.Lock()
_ATEXIT_REGISTERED = False


def _ensure_atexit() -> None:
    global _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        atexit.register(_atexit_dump)
        _ATEXIT_REGISTERED = True


def _atexit_dump() -> None:
    """Fallback trace dump for sessions still open at shutdown."""
    with _OPEN_LOCK:
        pending = list(_OPEN)
    for s in pending:
        s._dump_trace(reason="atexit")


class Session:
    """One workload's offload stack: config + runtime + interceptors.

    ``device`` is where offloaded work runs: ``None`` means ``cuda:0``
    (raising without CUDA), ``"cpu"`` the simulated tiers.
    ``intercept=False`` activates the runtime without patching the public
    symbols (the dlsym-mode analogue: callers use
    :mod:`repro_torch.core.blas` directly).

    ``name`` is the session's tenant id for multi-tenant runs: trace
    events are stamped with it and per-tenant pool statistics report
    under it; unnamed sessions stamp nothing.  ``pool`` joins the session
    to a :class:`~repro_torch.core.residency.SharedDevicePool` (quota
    from ``config.pool_quota``); with no explicit pool, setting
    ``config.pool_bytes``/``pool_quota`` joins the process-default pool.
    """

    def __init__(self, config: Optional[OffloadConfig] = None, *,
                 device=None, record_trace: bool = True,
                 intercept: bool = True, name: str = "", pool=None):
        self.config = (OffloadConfig.from_env() if config is None
                       else config)
        self.device = memspace.resolve_device(device)
        self.record_trace = record_trace
        self.intercept = intercept
        self.name = name
        self.pool = pool
        self.runtime = None
        self._trace_dumped = False
        # whether this session holds a reference on the solver patch
        # (config.lapack with intercept)
        self._lapack_patched = False

    # ------------------------------------------------------------------ #
    # lifecycle                                                           #
    # ------------------------------------------------------------------ #
    def open(self) -> "Session":
        """Create this session's runtime and make it the active dispatch
        target (pushing any currently-active session one level out)."""
        if self.runtime is not None:
            raise RuntimeError("session is already open")
        from repro_torch.core import intercept as icp
        from repro_torch.core import residency as res
        from repro_torch.core import runtime as rt
        self._trace_dumped = False
        pool = self.pool
        if pool is None and (self.config.pool_bytes is not None
                             or self.config.pool_quota is not None):
            pool = res.default_pool(self.config.pool_bytes)
        self.runtime = rt.OffloadRuntime(config=self.config,
                                         device=self.device,
                                         record_trace=self.record_trace,
                                         session_id=self.name, pool=pool)
        self.name = self.runtime.session_id     # a pool may assign one
        _STACK.set(_STACK.get() + (self,))
        with _OPEN_LOCK:
            _OPEN.append(self)
        rt.activate(self.runtime)
        if self.intercept:
            icp.patch_symbols()
            if self.config.lapack:
                self._patch_solvers(True)
        _ensure_atexit()
        return self

    def close(self):
        """Drain in-flight work, dump the trace (``config.trace_path``),
        deactivate, and return the final :class:`RuntimeStats`.  The
        outer session (if any) becomes active again.  Idempotent."""
        if self.runtime is None:
            return None
        from repro_torch.core import blas
        from repro_torch.core import intercept as icp
        from repro_torch.core import lapack
        from repro_torch.core import runtime as rt
        runtime, self.runtime = self.runtime, None
        try:
            runtime.sync()
        finally:
            self._dump_trace(runtime=runtime)
            runtime.detach_pool()
            runtime.release()
            stack = _STACK.get()
            if self in stack:
                _STACK.set(tuple(s for s in stack if s is not self))
            with _OPEN_LOCK:
                if self in _OPEN:
                    _OPEN.remove(self)
                last = not _OPEN
            if last:
                lapack.release_graphs()
            if self.intercept:
                self._patch_solvers(False)
                icp.unpatch_symbols()
            stack = _STACK.get()
            prev = stack[-1] if stack else None
            rt.activate(prev.runtime if prev is not None else None)
            if prev is not None:
                blas.refresh_cache_flag(prev.config.dispatch_cache)
        return runtime.stats

    def __enter__(self) -> "Session":
        if self.runtime is None:
            self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        return self.runtime is None

    @contextlib.contextmanager
    def scope(self):
        """Adopt this open session in the current thread (context).

        Sessions are context-local: a worker thread does not inherit the
        thread that opened them.  ``with s.scope():`` makes ``s`` the
        active dispatch target here without reopening it — several
        workers may scope one session concurrently (its runtime
        serializes their calls).  The previous state of this context is
        restored on exit."""
        self._require_open()
        from repro_torch.core import blas
        from repro_torch.core import runtime as rt
        token = _STACK.set(_STACK.get() + (self,))
        rt.activate(self.runtime)
        blas.refresh_cache_flag(self.config.dispatch_cache)
        try:
            yield self
        finally:
            _STACK.reset(token)
            stack = _STACK.get()
            prev = stack[-1] if stack else None
            rt.activate(prev.runtime if prev is not None else None)
            if prev is not None and prev.runtime is not None:
                blas.refresh_cache_flag(prev.config.dispatch_cache)

    # ------------------------------------------------------------------ #
    # what a workload reads off its session                               #
    # ------------------------------------------------------------------ #
    @property
    def stats(self):
        self._require_open()
        return self.runtime.stats

    @property
    def trace(self):
        """The recorded BLAS trace (None with ``record_trace=False``)."""
        self._require_open()
        return self.runtime.trace

    def report(self) -> str:
        """The runtime's statistics report, scoped to this session."""
        self._require_open()
        return self.runtime.stats.report()

    def sync(self) -> "Session":
        self._require_open()
        self.runtime.sync()
        return self

    def pin(self, x):
        """Pin a buffer on this session's device tier (survives cap
        pressure until :meth:`unpin` or buffer death)."""
        self._require_open()
        return self.runtime.pin(x)

    def unpin(self, x) -> None:
        self._require_open()
        self.runtime.unpin(x)

    def reconfigure(self, **kw) -> OffloadConfig:
        """Apply config changes to the live runtime: the new config is
        validated as a whole, the dispatch cache is flushed and the
        residency caps, eviction policy, pinning and fault knobs update
        in place.  ``devices`` cannot change on a live session (the
        block-store topology is fixed at open): that raises
        ``ValueError``.  Returns the new config."""
        self._require_open()
        new = self.config.replace(**kw)
        self.runtime.apply_config(new)
        self.config = new
        if self.intercept:
            # the solver patch follows the flag
            self._patch_solvers(new.lapack)
        return new

    def _patch_solvers(self, want: bool) -> None:
        """Take or release this session's reference on the solver
        trampolines, so that it holds one exactly when ``want``."""
        if want == self._lapack_patched:
            return
        from repro_torch.solvers import intercept as slv
        if want:
            slv.patch_symbols()
        else:
            slv.unpatch_symbols()
        self._lapack_patched = want

    # ------------------------------------------------------------------ #
    def _dump_trace(self, runtime=None, reason: str = "close") -> None:
        runtime = self.runtime if runtime is None else runtime
        if runtime is None or self._trace_dumped:
            return
        path = self.config.trace_path
        if not path or runtime.trace is None:
            return
        self._trace_dumped = True
        try:
            runtime.trace.dump(path)
            if self.config.debug >= 1:
                print(f"[scilib] trace ({len(runtime.trace)} calls) "
                      f"-> {path} ({reason})")
        except (OSError, TypeError, ValueError) as exc:
            # teardown must finish: a failed dump is reported, never
            # allowed to mask the exit status or half-close the session
            print(f"[scilib] trace dump to {path!r} failed: "
                  f"{type(exc).__name__}: {exc}")

    def _require_open(self) -> None:
        if self.runtime is None:
            raise RuntimeError("session is closed")

    def __repr__(self) -> str:
        state = "open" if self.runtime is not None else "closed"
        return f"Session({self.config!r}, device={self.device}, {state})"


def session(config: Optional[OffloadConfig] = None, *, device=None,
            record_trace: bool = True, intercept: bool = True,
            name: str = "", pool=None, **kw) -> Session:
    """Open a session (the primary public entry point).

    Returns an **open** session: use it as a context manager, or keep it
    and call ``close()``.  ``device=None`` runs on ``cuda:0`` and raises
    without CUDA; ``device="cpu"`` runs the simulated tiers.  Extra
    keyword arguments are config fields applied on top
    (``repro_torch.session(threshold=800)``).
    """
    if config is None:
        config = OffloadConfig.from_env()
    if kw:
        config = config.replace(**kw)
    return Session(config, device=device, record_trace=record_trace,
                   intercept=intercept, name=name, pool=pool).open()


def active_session() -> Optional[Session]:
    """The innermost open session of the current context, or None."""
    stack = _STACK.get()
    return stack[-1] if stack else None


# --------------------------------------------------------------------- #
# the implicit session stack behind the legacy shims                     #
# --------------------------------------------------------------------- #
#: sessions opened by ``install()`` (the runtime- and the intercept-level
#: shim share it), closed last-in first-out by ``uninstall()``
_LEGACY: ContextVar[Tuple[Session, ...]] = (
    ContextVar("scilib_torch_legacy_stack", default=()))


def open_legacy(config: OffloadConfig, *, record_trace: bool = True,
                intercept: bool = False, device=None) -> Session:
    """Open the implicit session behind a legacy ``install()`` call.
    Repeated calls nest: each ``uninstall()`` closes the most recent."""
    s = Session(config, device=device, record_trace=record_trace,
                intercept=intercept).open()
    _LEGACY.set(_LEGACY.get() + (s,))
    return s


def close_legacy():
    """Close the most recent legacy session (the ``uninstall()`` shim);
    else the innermost open session; else nothing.  Returns its final
    statistics, or None."""
    legacy = _LEGACY.get()
    if legacy:
        _LEGACY.set(legacy[:-1])
        return legacy[-1].close()
    s = active_session()
    return s.close() if s is not None else None
