"""Logical HOST/DEVICE memory tiers over PyTorch devices.

The port's counterpart of ``repro/core/memspace.py`` (single device).  The
paper's runtime moves buffers between host DRAM and device HBM.  Two
*logical* tiers name those homes:

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
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from contextvars import ContextVar
from typing import Dict, Hashable, Iterator, Optional, Tuple

import torch

#: logical tier names (stable across devices)
HOST = "host"
DEVICE = "device"


@dataclasses.dataclass(frozen=True)
class MemSpace:
    """Resolved mapping of the logical tiers onto one device."""

    device: torch.device   # home of DEVICE-tier buffers
    simulated: bool        # True on the CPU: tiers are tags on CPU tensors


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

# id(tensor) -> (weakref(tensor), logical tier).  Consulted only by the
# simulated tier, but host_array tags in both modes so that a tensor made
# outside a session keeps its tier inside a CPU session.
_TIERS: Dict[int, Tuple[weakref.ref, str]] = {}


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


def for_device(device: torch.device) -> MemSpace:
    """The mapping of one resolved device: real tiers on a card,
    simulated tiers on the CPU."""
    return MemSpace(device=device, simulated=device.type == "cpu")


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


def _tag(x: torch.Tensor, tier: str) -> None:
    key = id(x)

    def _drop(_ref, key=key):
        _TIERS.pop(key, None)

    _TIERS[key] = (weakref.ref(x, _drop), tier)


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


def put(x: torch.Tensor, tier: str) -> torch.Tensor:
    """Re-home a tensor to a logical tier (the ``move_pages()`` analogue).

    Real tiers copy across the link, to the session's device or to
    pinned host memory.  The simulated tier clones and tags the clone;
    the source keeps its own tag.  A tensor already on ``tier`` is
    returned as it is."""
    if tier_of(x) == tier:
        return x
    space = active()
    if not space.simulated:
        if tier == DEVICE:
            return x.to(space.device)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return host.copy_(x)
    moved = x.clone()
    _tag(moved, tier)
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
