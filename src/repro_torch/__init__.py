"""SCILIB-Accel on PyTorch and CUDA: automatic BLAS offload as a library.

The port of the JAX package ``repro`` to an NVIDIA H100.  The public
surface is the session API:

    import repro_torch
    from repro_torch import OffloadConfig

    with repro_torch.session(OffloadConfig(policy="dfu")) as s:
        ...                       # torch.matmul / @ / einsum intercepted
        print(s.report())

A session runs on the card (``cuda:0``) unless ``device="cpu"`` asks for
the simulated-tier mode on the CPU; without CUDA it raises.  The legacy
``install()``/``uninstall()``/``offload()`` surface is a shim over an
implicit session.  Concurrent sessions may share one device budget
(``SharedDevicePool``); ``faults`` is the fault model behind the
runtime's retry, host fallback and circuit breaker.  The dense LM
stack and its serving loop (``repro_torch.models``,
``repro_torch.train.Server``) follow the same rule.  Attributes resolve
lazily, so ``import repro_torch`` imports nothing heavy and
builds no kernel.
"""
from typing import TYPE_CHECKING

__all__ = ["OffloadConfig", "Session", "session", "active_session",
           "install", "uninstall", "offload", "SharedDevicePool",
           "default_pool", "faults", "core", "models", "train", "solvers",
           "memtier", "tools"]

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.config import OffloadConfig
    from repro_torch.core.session import Session, active_session, session

_CONFIG_NAMES = ("OffloadConfig",)
_SESSION_NAMES = ("Session", "session", "active_session")
_LEGACY_NAMES = ("install", "uninstall", "offload")
_POOL_NAMES = ("SharedDevicePool", "default_pool")


def __getattr__(name: str):
    import importlib
    if name in _CONFIG_NAMES:
        return getattr(importlib.import_module("repro_torch.core.config"),
                       name)
    if name in _SESSION_NAMES:
        return getattr(importlib.import_module("repro_torch.core.session"),
                       name)
    if name in _LEGACY_NAMES:
        return getattr(importlib.import_module("repro_torch.core.intercept"),
                       name)
    if name in _POOL_NAMES:
        return getattr(importlib.import_module("repro_torch.core.residency"),
                       name)
    if name == "faults":
        return importlib.import_module("repro_torch.core.faults")
    if name in ("core", "models", "train", "solvers", "memtier", "tools"):
        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
