"""Logical HOST/DEVICE memory tiers over PyTorch devices.

The port's counterpart of ``repro/core/memspace.py``.  The paper's
runtime moves buffers between host DRAM and device HBM.  Two *logical*
tiers name those homes:

* :data:`HOST`   — where CPU-first-touched data lives (the malloc side),
* :data:`DEVICE` — where offloaded BLAS wants its operands (the HBM side).

A session runs on one ``torch.device``:

* ``cuda:0`` (the default): real tiers.  HOST is CPU tensors (pinned),
  DEVICE is tensors on the card, :func:`tier_of` reads ``tensor.device``
  and :func:`put` is a real copy across the link.
* ``cpu`` (what the tests pass): the **simulated tier** of
  ``memspace.py:16-23``.  Both tiers are CPU tensors; the tier is a tag
  kept in a side table keyed on the tensor object, a cross-tier
  :func:`put` materializes a copy with the other tag, and untagged
  tensors count as DEVICE (``memspace.py:239-260``), so every policy runs
  and counts exactly as on the card.

Buffer identity for placements is :func:`buffer_key`: storage address,
offset, shape, strides and dtype, which is what the page table of the
paper keys on.  Torch tensors are mutable, unlike JAX arrays, so a
placement also records the source's :func:`version_of` (its
``_version`` counter, shared with its views): a host tensor written in
place after it migrated no longer matches its device copy, and the
policies treat the copy as stale.

The DEVICE tier also carries a **device index** for the multi-device
tile scheduler (``OffloadConfig.devices``): :func:`put_block` places a
block onto one device tier and tags it with the index, and
:func:`device_of` reads the tag back.  With several cards the block is
copied onto ``cuda:<index>``; with one card (or on the CPU) every tier
lives in the same memory, so the index is only the tag, and an untagged
tensor has none — a block of a device-born operand is then still copied
once per tier, as the reference's simulated layout does
(``repro/core/memspace.py:330-387``).

**Failure semantics.**  A real movement toward DEVICE is a transfer guard
site: the active runtime installs its fault injector as this context's
hook (:func:`set_fault_hook`), which runs before any copy is made, and a
failed copy (``torch.cuda.OutOfMemoryError`` among others) is raised as
the typed hierarchy of :mod:`repro_torch.core.faults`, so the runtime's
retry and fallback guard can absorb it.  ``check=False`` opts a movement
out of injection (the host path's streaming, ``pin``, the serving
loop's cache placement).  The hook, the debug level and the installed
mapping are context-local: one thread's injector never fires in another
thread's transfers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from contextvars import ContextVar
from typing import Callable, Dict, Hashable, Iterator, Optional, Tuple

import torch

from repro_torch.core import faults as flt

#: logical tier names (stable across devices)
HOST = "host"
DEVICE = "device"

#: (device_index_or_None, nbytes) -> None; raises to inject a fault
_FAULT_HOOK: ContextVar[Optional[Callable[[Optional[int], int], None]]] = (
    ContextVar("scilib_torch_fault_hook", default=None))

#: the owning config's ``debug`` level (plumbed in by the runtime)
_DEBUG: ContextVar[int] = ContextVar("scilib_torch_debug", default=0)

#: exception types a data movement may legitimately raise
#: (``torch.cuda.OutOfMemoryError`` is a RuntimeError); anything else is
#: a bug and propagates as it is
_MOVE_ERRORS = (RuntimeError, MemoryError, OSError)


def set_fault_hook(hook: Optional[Callable[[Optional[int], int], None]],
                   ) -> None:
    """Install (or clear, with None) this context's transfer-fault hook.
    The runtime points it at the active runtime's injector on activation
    and reconfiguration; it runs before every real movement toward a
    DEVICE tier, except those made with ``check=False``."""
    _FAULT_HOOK.set(hook)


def set_debug(level: int) -> None:
    """Plumb the config's ``debug`` level in (this module reads no
    environment)."""
    _DEBUG.set(int(level))


def _debug_log(msg: str, level: int = 1) -> None:
    if _DEBUG.get() >= level:
        print(f"[scilib] {msg}")


@dataclasses.dataclass(frozen=True)
class MemSpace:
    """Resolved mapping of the logical tiers onto one device."""

    device: torch.device   # home of DEVICE-tier buffers
    simulated: bool        # True on the CPU: tiers are tags on CPU tensors
    n_devices: int = 1     # logical DEVICE tiers (the tile scheduler's)

    def kind_of(self, tier: str) -> str:
        """The memory kind behind a logical tier, in JAX's names: on the
        card ``pinned_host`` for HOST (page-locked CPU memory) and
        ``device`` for DEVICE; on the simulated tiers one memory backs
        both, ``device``, as a backend with a single memory kind reports
        it."""
        if tier == HOST and not self.simulated:
            return "pinned_host"
        return "device"


def device_bytes_from_env() -> Optional[int]:
    """The per-device-tier byte cap (``SCILIB_DEVICE_BYTES``) read
    through the config boundary (:meth:`repro_torch.core.config.
    OffloadConfig.from_env`).  The runtime itself takes its config's
    ``device_bytes``."""
    from repro_torch.core.config import OffloadConfig
    return OffloadConfig.from_env().device_bytes


def resolve_device(device=None) -> torch.device:
    """The device a session or entry point runs on.  ``None`` means the
    card, ``cuda:0``; without CUDA that raises instead of running on the
    CPU.  The CPU runs only when asked for (``device="cpu"``)."""
    if device is None:
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda:N' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{dev} requested but CUDA is not available; pass "
            f"device='cpu' to run the simulated-tier mode on the CPU")
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def probe() -> MemSpace:
    """The mapping for code outside any session: real tiers on
    ``cuda:0`` when there is a card, else the simulated tiers."""
    if torch.cuda.is_available():
        return MemSpace(device=torch.device("cuda", 0), simulated=False)
    return MemSpace(device=torch.device("cpu"), simulated=True)


# --------------------------------------------------------------------- #
# module state: active mapping + simulated-tier tag table                 #
# --------------------------------------------------------------------- #
# The installed mapping is context-local (a session's device must not
# leak into a neighbouring thread); the fallback for code running outside
# any session is probed once, process-wide: the card when there is one.
_ACTIVE: ContextVar[Optional[MemSpace]] = (
    ContextVar("scilib_torch_memspace", default=None))
_PROBED: Optional[MemSpace] = None
_PROBE_LOCK = threading.Lock()

# id(tensor) -> (weakref(tensor), logical tier, device index).  The tier
# is consulted only by the simulated tier, but host_array tags in both
# modes so that a tensor made outside a session keeps its tier inside a
# CPU session; the device index is read in both modes (device_of).
_TIERS: Dict[int, Tuple[weakref.ref, str, int]] = {}


def active() -> MemSpace:
    """The context's installed mapping, else the process default."""
    space = _ACTIVE.get()
    if space is not None:
        return space
    global _PROBED
    with _PROBE_LOCK:
        if _PROBED is None:
            _PROBED = probe()
        return _PROBED


def install(space: MemSpace) -> MemSpace:
    """Make ``space`` this context's mapping (the runtime does this)."""
    _ACTIVE.set(space)
    return space


def uninstall() -> None:
    _ACTIVE.set(None)


def reset() -> None:
    """Forget this context's mapping, the probed default and every
    simulated-tier tag."""
    global _PROBED
    _ACTIVE.set(None)
    with _PROBE_LOCK:
        _PROBED = None
    _TIERS.clear()


@contextlib.contextmanager
def installed(space: MemSpace) -> Iterator[MemSpace]:
    """Make ``space`` this context's mapping for the ``with`` block, then
    restore whatever was installed before (entry points that own their
    device, like the serving loop, use this instead of :func:`probe`)."""
    token = _ACTIVE.set(space)
    try:
        yield space
    finally:
        _ACTIVE.reset(token)


def for_device(device: torch.device, n_devices: int = 1) -> MemSpace:
    """The mapping of one resolved device: real tiers on a card,
    simulated tiers on the CPU; ``n_devices`` logical device tiers."""
    return MemSpace(device=device, simulated=device.type == "cpu",
                    n_devices=max(1, int(n_devices)))


def n_devices() -> int:
    """Number of logical device tiers of the active mapping."""
    return active().n_devices


def nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def version_of(x: torch.Tensor) -> int:
    """The tensor's in-place write counter (shared with its views);
    inference tensors keep none and read as 0."""
    try:
        return x._version
    except RuntimeError:      # inference tensors track no version
        return 0


def buffer_key(x: torch.Tensor) -> Hashable:
    """Placement identity: the memory a tensor views, not the object."""
    return (x.device.type, x.untyped_storage().data_ptr(),
            x.storage_offset(), tuple(x.shape), tuple(x.stride()), x.dtype)


def _tag(x: torch.Tensor, tier: str, device: int = 0) -> None:
    key = id(x)

    def _drop(_ref, key=key):
        _TIERS.pop(key, None)

    _TIERS[key] = (weakref.ref(x, _drop), tier, device)


def tier_of(x: torch.Tensor) -> str:
    """Logical tier of a tensor (HOST or DEVICE).

    Real tiers: a CUDA tensor is DEVICE, a CPU tensor HOST.  Simulated
    tier: the tag, and DEVICE for an untagged tensor (freshly made
    tensors are born in device memory on the card, and the simulation
    mirrors that); CPU-first-touched inputs come through
    :func:`repro_torch.core.policy.host_array`.
    """
    if not active().simulated:
        return DEVICE if x.device.type == "cuda" else HOST
    ent = _TIERS.get(id(x))
    if ent is not None and ent[0]() is not None:
        return ent[1]
    return DEVICE


def device_of(x: torch.Tensor) -> Optional[int]:
    """Device-tier index of a tensor, or None when it has no explicit
    device placement (host-resident, or never routed by the tile
    scheduler).  The index is a tag set by :func:`put_block`; with
    several cards an untagged CUDA tensor reads its card's index, while
    on one card (or on the CPU) an untagged tensor has none."""
    ent = _TIERS.get(id(x))
    if ent is not None and ent[0]() is not None:
        return ent[2] if ent[1] == DEVICE else None
    if (not active().simulated and x.device.type == "cuda"
            and torch.cuda.device_count() > 1):
        return x.device.index
    return None


def put(x: torch.Tensor, tier: str, *, check: bool = True) -> torch.Tensor:
    """Re-home a tensor to a logical tier (the ``move_pages()`` analogue).

    Real tiers copy across the link, to the session's device or to
    pinned host memory.  The simulated tier clones and tags the clone;
    the source keeps its own tag.  A tensor already on ``tier`` is
    returned as it is.  A movement toward DEVICE runs the fault hook
    first (unless ``check=False``), and a failed copy raises the typed
    hierarchy of :mod:`repro_torch.core.faults`."""
    if tier_of(x) == tier:
        return x
    size = nbytes(x)
    hook = _FAULT_HOOK.get()
    if check and tier == DEVICE and hook is not None:
        hook(None, size)
    space = active()
    try:
        if not space.simulated:
            if tier == DEVICE:
                return x.to(space.device)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return host.copy_(x)
        moved = x.clone()
    except _MOVE_ERRORS as exc:
        flt.raise_typed("transfer", exc, device=None, nbytes=size)
    _tag(moved, tier)
    return moved


def put_block(x: torch.Tensor, device: int) -> torch.Tensor:
    """Place a block onto one DEVICE tier (tile scheduling).

    With several cards the block is copied onto ``cuda:<device>``;
    otherwise every tier shares the session's memory and the block is
    copied there (a copy across the link for a host block, a copy on the
    device for a device-born one), so per-tier movement is counted the
    same way on one card as on many.  The copy is tagged
    ``(DEVICE, device)``; a block already tagged with this tier is
    returned as it is.  Like :func:`put`, the fault hook runs first (with
    the tier index, so ``device=`` rules target one tier) and a failed
    copy raises the typed hierarchy."""
    if tier_of(x) == DEVICE and device_of(x) == device:
        return x
    size = nbytes(x)
    hook = _FAULT_HOOK.get()
    if hook is not None:
        hook(device, size)
    space = active()
    try:
        if space.simulated:
            moved = x.clone()
        else:
            cards = torch.cuda.device_count()
            home = (torch.device("cuda", device % cards) if cards > 1
                    else space.device)
            moved = torch.empty(x.shape, dtype=x.dtype, device=home)
            moved.copy_(x)
    except _MOVE_ERRORS as exc:
        flt.raise_typed("transfer", exc, device=device, nbytes=size)
    _tag(moved, DEVICE, device)
    _debug_log(f"put_block: {size} B -> dev{device}", level=2)
    return moved


def tag_host_input(x: torch.Tensor) -> torch.Tensor:
    """Mark a CPU tensor as host-first-touched in either mode."""
    _tag(x, HOST)
    return x


def tag_device(x: torch.Tensor) -> torch.Tensor:
    """Mark a tensor device-resident without moving it (outputs of
    offloaded compute are born on the device tier)."""
    if active().simulated and tier_of(x) != DEVICE:
        _tag(x, DEVICE)
    return x


def tag_host(x: torch.Tensor) -> torch.Tensor:
    """Mark a tensor host-resident without moving it (eviction
    bookkeeping in simulated mode: its next device use re-migrates)."""
    if active().simulated and tier_of(x) != HOST:
        _tag(x, HOST)
    return x
