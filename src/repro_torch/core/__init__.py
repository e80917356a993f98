"""SCILIB-Accel core on PyTorch: the paper's contribution as a module.

The port's counterpart of ``repro/core``.  Public surface:

* :mod:`repro_torch.core.blas` — BLAS routines (dlsym-mode API).
* :mod:`repro_torch.core.intercept` — the trampolines over
  ``torch.matmul``/``@``/``mm``/``mv``/``dot``/``bmm``/``einsum``/
  ``tensordot`` (DBI mode), and the legacy ``install``/``uninstall``/
  ``offload`` shims.
* :mod:`repro_torch.core.lapack` — blocked LU and Cholesky over the
  intercepted BLAS (the solver tier's arithmetic).
* :mod:`repro_torch.core.runtime` — the placement runtime + statistics
  (asynchronous on the card; ``sync=True`` or ``runtime.sync()`` fence).
* :mod:`repro_torch.core.policy` — Mem-Copy / counter / Device-First-Use
  / pinned / cpu data-movement policies and ``host_array``.
* :mod:`repro_torch.core.memspace` — the logical HOST/DEVICE tiers on a
  ``torch.device`` (simulated tiers on the CPU).
* :mod:`repro_torch.core.callsite` — per-call-site fingerprints.
* :mod:`repro_torch.core.residency` — the byte-capped, evicting,
  pinnable block store behind the placement registry, and the
  :class:`SharedDevicePool` concurrent sessions share.
* :mod:`repro_torch.core.faults` — the fault model: typed errors,
  injection, retry/backoff, the per-tier circuit breaker.
* :mod:`repro_torch.core.config` — :class:`OffloadConfig`, the same
  fields and ``SCILIB_*`` names as the reference.
* :mod:`repro_torch.core.session` — :class:`Session`.
* :mod:`repro_torch.core.trace` — the BLAS trace, in the reference schema.
"""
from repro_torch.core import (blas, callsite, faults, lapack, memspace,
                              residency)
from repro_torch.core.config import OffloadConfig
from repro_torch.core.intercept import install, offload, uninstall
from repro_torch.core.policy import host_array
from repro_torch.core.residency import (ResidencyStore, SharedDevicePool,
                                        default_pool)
from repro_torch.core.runtime import OffloadRuntime, active, pin, unpin
from repro_torch.core.session import Session, active_session
from repro_torch.core.trace import BlasCall, Trace

__all__ = ["blas", "callsite", "faults", "lapack", "memspace", "residency",
           "install", "offload", "uninstall", "OffloadRuntime",
           "active", "BlasCall", "Trace", "host_array", "ResidencyStore",
           "SharedDevicePool", "default_pool", "pin", "unpin",
           "OffloadConfig", "Session", "active_session"]
