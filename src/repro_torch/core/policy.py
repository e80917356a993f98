"""Data-movement policies (paper §3.2) over the logical memory tiers.

The port's counterpart of ``repro/core/policy.py``: the paper's three
strategies plus two controls, over the HOST/DEVICE tiers of
:mod:`repro_torch.core.memspace` (real copies on the card, tag plus copy
on the CPU).

Placement state lives in the runtime's residency store
(``runtime.placements``), keyed on the memory a tensor views
(:func:`~repro_torch.core.memspace.buffer_key`): a matrix moved by Device
First-Use stays device-resident for every later call that passes the
same memory — that store *is* the page-table remap of the paper's
Fig. 2.  Each entry's payload is a :class:`Resident`, which also records
the source's version counter, so a host tensor written in place after it
moved gets a fresh copy instead of the stale one.  Tile blocks of the
multi-device scheduler live in ``runtime.block_stores[d]``, one store per
device tier; :meth:`PolicyBase.select_device` reads them to keep a tile
where its blocks already are.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Hashable, Optional, Tuple

import torch

from repro_torch.core import memspace, spans

#: logical tier names, re-exported for the runtime and tests
HOST_KIND = memspace.HOST
DEVICE_KIND = memspace.DEVICE


def _put(x: torch.Tensor, tier: str) -> torch.Tensor:
    """Re-home a buffer to a logical tier (the move_pages() analogue)."""
    return memspace.put(x, tier)


def memory_kind_of(x: torch.Tensor) -> str:
    """Logical tier of a buffer (kept under its historical name)."""
    return memspace.tier_of(x)


def host_array(x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The malloc() analogue: materialize data on the HOST tier.

    Takes a numpy array, a tensor or nested sequences.  Application
    inputs in the paper are CPU-first-touched; use this for inputs so the
    offload policies have real movement to manage.  On the card the
    result is a pinned CPU tensor."""
    t = torch.as_tensor(x, dtype=dtype, device="cpu")
    if memspace.active().simulated:
        return _put(t, HOST_KIND)
    return memspace.tag_host_input(t.pin_memory())


@dataclasses.dataclass(frozen=True, eq=False)
class Resident:
    """Payload of one placements-store entry."""

    #: the device-tier copy, or None when the source itself was already
    #: device-resident (then the entry holds no extra memory)
    copy: Optional[torch.Tensor]
    #: the source's version counter when it was placed
    version: int
    #: the application's tensor
    source: weakref.ref

    def array(self) -> Optional[torch.Tensor]:
        return self.copy if self.copy is not None else self.source()


@dataclasses.dataclass
class Placement:
    """Outcome of placing one operand for one call."""

    array: torch.Tensor
    moved_bytes: int = 0
    cache_hit: bool = False


def lookup(runtime, x: torch.Tensor
           ) -> Tuple[Hashable, Optional[torch.Tensor], bool]:
    """The placement key of ``x``, its resident device-tier tensor or
    None, and whether a stale copy was dropped: a copy whose source was
    written in place since it moved is dropped and the lookup misses."""
    store = runtime.placements
    key = memspace.buffer_key(x)
    ent = store.entry(key)
    stale = (ent is not None and ent.payload.copy is not None
             and ent.payload.version != memspace.version_of(x))
    if stale:
        store.drop(key)
    res = store.get(key)
    if res is None:
        return key, None, stale
    return key, res.copy if res.copy is not None else x, stale


def register(runtime, key: Hashable, x: torch.Tensor,
             copy: Optional[torch.Tensor] = None) -> None:
    """Record ``x`` (or its device-tier ``copy``) as resident.  The
    store remembers a copy's version if ``x`` dies, so a move of the
    same memory at that version is told apart (:func:`_move_reason`)."""
    version = memspace.version_of(x)
    runtime.placements.put(
        key, Resident(copy, version, weakref.ref(x)), memspace.nbytes(x),
        anchor=x, version=None if copy is None else version)


def _move_reason(runtime, key: Hashable, x: torch.Tensor,
                 stale: bool = False) -> str:
    """Why placing ``x`` under ``key`` moves it (a move span's name):
    ``refetch`` after a pressure eviction; ``stale`` after a copy of a
    source written since was dropped; ``again`` where the key's copy
    dropped with its anchor and the memory is unchanged; else
    ``first``."""
    store = runtime.placements
    if store.refetching(key):
        return "refetch"
    dropped = store.dropped_version(key)
    if stale or (dropped is not None
                 and dropped != memspace.version_of(x)):
        return "stale"
    return "first" if dropped is None else "again"


def move(runtime, x: torch.Tensor, key: Optional[Hashable] = None,
         stale: bool = False, *, check: bool = True) -> torch.Tensor:
    """Copy ``x`` to the device tier, under a ``scilib.move.<reason>``
    span while a profiler records (``key``: ``x``'s placement key, where
    the caller has it)."""
    if not spans.enabled():
        return memspace.put(x, DEVICE_KIND, check=check)
    if key is None:
        key = memspace.buffer_key(x)
    with spans.span("scilib.move.", _move_reason(runtime, key, x, stale)):
        return memspace.put(x, DEVICE_KIND, check=check)


class PolicyBase:
    """Interface: how operands reach the device tier and results return."""

    name = "base"
    #: whether outputs of offloaded calls are copied back to the host tier
    copy_back = False
    #: whether placements persist across calls (the reuse mechanism)
    persistent = True
    #: whether this policy executes on the device tier at all — the
    #: dispatch pipeline's decide stage vetoes offload when False
    offloads = True
    #: whether the multi-device tile scheduler may shard calls under this
    #: policy.  Only policies that migrate every operand on (first) use
    #: keep their semantics when the runtime moves blocks itself; the
    #: access-counter model decides per operand and stays single-device
    #: or it would silently become DFU.
    shardable = True

    def place_operand(self, runtime, x: torch.Tensor) -> Placement:
        raise NotImplementedError

    def place_output(self, runtime, y: torch.Tensor) -> Placement:
        """Offloaded compute produces device-tier outputs; policies decide
        whether they stay (DFU) or bounce back to host (Mem-Copy)."""
        if self.copy_back:
            with spans.span("scilib.move.out"):
                host = _put(y, HOST_KIND)
            return Placement(host, moved_bytes=memspace.nbytes(y))
        return Placement(memspace.tag_device(y))

    def select_device(self, runtime, blocks) -> int:
        """Which device tier runs one tile of a sharded call (BLASX-style
        round-robin with affinity).

        ``blocks``: (key, nbytes, shared) per tile operand.  Persistent
        policies prefer the tier already holding the most operand-block
        bytes — first use moved the block there, every later tile on the
        same tier is free.  Blocks shared by every tile (trsm's triangle)
        replicate and never steer the choice.  With no residency
        anywhere, tiles deal round-robin.  Score ties break toward the
        tier with the fewest tiles scheduled in this call, so a block
        replicated by an earlier grid cannot funnel a whole grid onto one
        tier.  A quarantined tier (breaker open) is never selected, even
        by affinity."""
        if self.persistent:
            scores: dict = {}
            for key, nbytes, shared in blocks:
                if shared:
                    continue
                for home, store in enumerate(runtime.block_stores):
                    if key in store and runtime.device_usable(home):
                        scores[home] = scores.get(home, 0) + nbytes
            if scores:
                return min(scores, key=lambda d: (-scores[d],
                                                  runtime.scheduled_load(d),
                                                  d))
        return runtime.next_device()


class MemCopyPolicy(PolicyBase):
    """Strategy 1 (§3.2.1): stage in and out around *every* call."""

    name = "memcopy"
    copy_back = True
    persistent = False

    def place_operand(self, runtime, x):
        if memspace.tier_of(x) == DEVICE_KIND:
            # even Mem-Copy tools skip the copy when data is already there
            return Placement(x, cache_hit=True)
        return Placement(move(runtime, x),
                         moved_bytes=memspace.nbytes(x))


class DeviceFirstUsePolicy(PolicyBase):
    """Strategy 3 (§3.2.3): the paper's contribution.

    First device use migrates the buffer to the device tier and registers
    the placement; every later use of the same buffer is a cache hit with
    zero movement. Outputs are born device-resident and registered, so
    chained calls (``C = A·B`` then ``E = D·C``) never touch the link.
    """

    name = "dfu"

    def place_operand(self, runtime, x):
        key, cached, stale = lookup(runtime, x)
        if cached is not None:
            return Placement(cached, cache_hit=True)
        if memspace.tier_of(x) == DEVICE_KIND:
            register(runtime, key, x)
            return Placement(x)
        moved = move(runtime, x, key, stale)
        register(runtime, key, x, moved)
        return Placement(moved, moved_bytes=memspace.nbytes(x))

    def place_output(self, runtime, y):
        memspace.tag_device(y)
        register(runtime, memspace.buffer_key(y), y)
        return Placement(y)


class CounterPolicy(PolicyBase):
    """Strategy 2 (§3.2.2): model of the hardware access-counter migration.

    Reproduces the size- and reuse-biased behaviour measured in Table 6
    (rules R1-R4 of ``repro.memtier.simulator``): some operands never
    migrate and are streamed from the host tier on every call — which is
    why this policy loses to DFU in the paper's application tests.
    """

    name = "counter"
    shardable = False     # R1-R4 are per-operand host-vs-device rules

    reuse_min = 100.0
    byte_budget = 3.4e9
    c_small = 16e6

    def place_operand(self, runtime, x, *, reads_per_elem: float = 1.0,
                      written: bool = False, ai: float = 0.0,
                      budget_used: int = 0) -> Placement:
        key, cached, stale = lookup(runtime, x)
        if cached is not None:
            return Placement(cached, cache_hit=True)
        if memspace.tier_of(x) == DEVICE_KIND:
            register(runtime, key, x)
            return Placement(x)
        size = memspace.nbytes(x)
        if written:
            ok = size <= self.c_small and ai >= 30.0
        else:
            ok = (reads_per_elem >= self.reuse_min
                  and budget_used + size <= self.byte_budget)
        if not ok:
            return Placement(x)         # stays host: remote-streamed reads
        moved = move(runtime, x, key, stale)
        register(runtime, key, x, moved)
        return Placement(moved, moved_bytes=size)


class PinnedDevicePolicy(DeviceFirstUsePolicy):
    """``numactl -m 1`` control: everything lives on the device tier.
    Operands are placed as under DFU; outputs are tagged, not
    registered."""

    name = "pinned"
    place_output = PolicyBase.place_output


class CpuOnlyPolicy(PolicyBase):
    """Baseline: never offload (the paper's NVPL CPU runs)."""

    name = "cpu"
    persistent = False
    offloads = False

    def place_operand(self, runtime, x):
        return Placement(x)


POLICY_CLASSES = {
    p.name: p for p in (MemCopyPolicy, CounterPolicy, DeviceFirstUsePolicy,
                        PinnedDevicePolicy, CpuOnlyPolicy)
}


def make_policy(name: str) -> PolicyBase:
    try:
        return POLICY_CLASSES[name]()
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; choose from {sorted(POLICY_CLASSES)}")
