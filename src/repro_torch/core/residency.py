"""The residency engine: one block store behind runtime, scheduler, sim.

The port's copy of ``repro/core/residency.py``: entries, events,
eviction policies, :class:`ResidencyStore` and the shared multi-tenant
:class:`SharedDevicePool`.

The paper's core claim is that residency — not dispatch — dominates
offload cost (Fig. 2, Tables 3/5): Device First-Use wins because a
buffer moves once and every later use is free, and BLASX shows the same
lesson at tile granularity with a software cache plus an eviction
discipline.  Before this module the repo had four drifting copies of
that bookkeeping: the runtime's whole-buffer placement registry, the
per-device tile-block registries, the trace-id weakref table, and the
memtier simulator's own device-residency model.  They could not agree —
so the autotuner's replay predictions could not see the live runtime's
cap-induced evictions and refetches.

:class:`ResidencyStore` is the single implementation all four now
share.  It is a keyed table of resident entries with

* **byte accounting** — every entry carries ``nbytes``; the store keeps
  ``resident_bytes`` exact at all times,
* **weakref lifecycle** — an entry may be anchored to a live object
  (the application's array); when the anchor dies the entry drops
  itself, exactly like the old registries' weakref callbacks,
* **pin flags** — pinned entries survive arbitrary cap pressure
  (``runtime.pin(x)``, or ``SCILIB_PIN=never-evict`` to pin every
  placement),
* **byte caps** with **pluggable eviction policies** — ``lru`` (the
  default, byte-for-byte the pre-refactor behaviour), ``lfu`` (evict
  the least-used entry), and ``refetch`` (cost-aware: evict the entry
  with the cheapest bytes-to-refetch-per-use, so a big rarely-reused
  block goes before a small hot one), selected with ``SCILIB_EVICT``,
* **residency events** — ``place`` / ``hit`` / ``evict`` / ``refetch``
  emitted through a callback the runtime points at the trace, so a
  recorded run carries its residency history and the simulator's replay
  can be checked against it count-for-count.

Two admission semantics coexist because the live runtime and the
hardware model genuinely differ:

* :meth:`ResidencyStore.put` is the *runtime registry* semantic —
  admit, then evict other entries until back under the cap (the entry
  just placed is in use by the current call and is protected, so one
  oversized buffer is admitted rather than thrashed);
* :meth:`ResidencyStore.reserve` is the *HBM capacity* semantic the
  simulator's page table needs — check (and optionally make) room
  first, refuse the migration entirely when it cannot fit.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Callable, Dict, Hashable, Iterator, List, Optional, Tuple

__all__ = ["Entry", "ResidencyEvent", "ResidencyStore", "SharedDevicePool",
           "EVICTION_POLICIES", "make_eviction_policy",
           "evict_policy_from_env", "pin_all_from_env", "default_pool",
           "reset_default_pool"]


# --------------------------------------------------------------------- #
# entries and events                                                     #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Entry:
    """One resident block: payload + the accounting the policies read."""

    key: Hashable
    payload: object            # placed array / Buffer / trace-buffer id
    nbytes: int
    pinned: bool = False
    uses: int = 0              # lookup hits (LFU / refetch-cost input)
    ref: Optional[weakref.ref] = None   # lifecycle anchor (may be None)


@dataclasses.dataclass(frozen=True)
class ResidencyEvent:
    """One residency transition, recorded into the trace.

    ``store`` names the owning store (``"placements"``, ``"dev0"``...),
    ``call_index`` is the position in ``Trace.calls`` at emission time
    (-1 when no trace context exists), so events interleave with the
    call stream on replay.  ``session`` is the owning session's id for
    multi-tenant runs; unnamed single-tenant sessions leave it empty
    and their serialized form is unchanged (dumps stay byte-identical
    to pre-tenant traces).
    """

    kind: str                  # "place" | "hit" | "evict" | "refetch"
    store: str
    nbytes: int
    call_index: int = -1
    session: str = ""

    def to_json(self):
        d = dataclasses.asdict(self)
        if not d["session"]:
            del d["session"]
        return d


# --------------------------------------------------------------------- #
# eviction policies                                                      #
# --------------------------------------------------------------------- #
class EvictionPolicy:
    """Chooses the next victim among evictable entries.

    ``entries`` is the store's ordered table — least-recently-used
    first, because lookups and placements move entries to the end.
    ``protect`` is the entry the current call just placed (never a
    victim).  Return ``None`` when nothing is evictable.
    """

    name = "base"

    def victim(self, entries: "collections.OrderedDict[Hashable, Entry]",
               protect: Optional[Hashable]) -> Optional[Hashable]:
        raise NotImplementedError

    @staticmethod
    def _candidates(entries, protect) -> Iterator[Entry]:
        for key, ent in entries.items():
            if key == protect or ent.pinned:
                continue
            yield ent


class LruPolicy(EvictionPolicy):
    """Evict the least-recently-used entry (pre-refactor behaviour)."""

    name = "lru"

    def victim(self, entries, protect):
        for ent in self._candidates(entries, protect):
            return ent.key
        return None


class LfuPolicy(EvictionPolicy):
    """Evict the least-frequently-used entry; ties fall back to LRU."""

    name = "lfu"

    def victim(self, entries, protect):
        best = None
        for ent in self._candidates(entries, protect):
            if best is None or ent.uses < best.uses:
                best = ent
        return None if best is None else best.key


class RefetchCostPolicy(EvictionPolicy):
    """Cost-aware: evict the cheapest bytes-to-refetch-per-use.

    Refetching an evicted entry costs its ``nbytes`` over the link; an
    entry's uses say how often that cost would recur.  Evicting the
    entry with the smallest ``nbytes / uses`` sacrifices the least
    expected future traffic — a large block used once goes before a
    small block in every call.  Ties fall back to LRU order.
    """

    name = "refetch"

    def victim(self, entries, protect):
        best, best_cost = None, None
        for ent in self._candidates(entries, protect):
            cost = ent.nbytes / max(1, ent.uses)
            if best is None or cost < best_cost:
                best, best_cost = ent, cost
        return None if best is None else best.key


EVICTION_POLICIES = {p.name: p for p in (LruPolicy, LfuPolicy,
                                         RefetchCostPolicy)}


def make_eviction_policy(name: str) -> EvictionPolicy:
    try:
        return EVICTION_POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown eviction policy {name!r}; choose from "
                         f"{sorted(EVICTION_POLICIES)}")


def evict_policy_from_env(default: str = "lru") -> str:
    """The ``SCILIB_EVICT`` knob read through the config boundary
    (:meth:`repro_torch.core.config.OffloadConfig.from_env`): an unknown
    value falls back to ``default``.  The runtime itself takes its
    config's ``evict`` field."""
    from repro_torch.core.config import OffloadConfig
    return OffloadConfig.from_env(OffloadConfig(evict=default)).evict


def pin_all_from_env() -> bool:
    """Whether ``SCILIB_PIN`` pins every placement at registration
    (``never-evict``: residency only grows, caps never evict), read
    through the config boundary.  The runtime itself takes its config's
    ``pin`` field."""
    from repro_torch.core.config import OffloadConfig
    return OffloadConfig.from_env().pin


# --------------------------------------------------------------------- #
# the store                                                              #
# --------------------------------------------------------------------- #
#: anchored keys a store remembers after their anchor died (newest kept)
DROPPED_KEYS = 1024


class ResidencyStore:
    """Byte-capped keyed residency table with pluggable eviction.

    The ordered table doubles as the recency list: :meth:`get` hits and
    :meth:`put` placements move entries to the end, so iteration order
    is always least-recently-used first — the ``lru`` policy just takes
    the front, and ``lfu``/``refetch`` break their ties on it.

    ``on_evict(key, payload, nbytes)`` runs for every *pressure*
    eviction (not lifecycle drops): the owner re-tags tiers, bills
    statistics, or moves simulated pages there.  ``emit(kind, store,
    nbytes)`` mirrors place/hit/evict/refetch into the owner's trace.

    Every mutating method holds the store's reentrant lock — reentrant
    because weakref lifecycle callbacks and ``on_evict``/``emit`` hooks
    can re-enter the store from inside an eviction sweep.  Lock order
    is store → pool: the store notifies its :class:`SharedDevicePool`
    (if bound) while holding its own lock, and the pool never calls
    back into a store while holding the pool lock.
    """

    def __init__(self, name: str = "store", *,
                 cap: Optional[int] = None,
                 policy: str = "lru",
                 on_evict: Optional[Callable] = None,
                 emit: Optional[Callable] = None,
                 pin_new: bool = False):
        self.name = name
        self.cap = cap
        self.policy = make_eviction_policy(policy)
        self.on_evict = on_evict
        self.emit = emit
        self.pin_new = pin_new
        self._lock = threading.RLock()
        self._entries: "collections.OrderedDict[Hashable, Entry]" = (
            collections.OrderedDict())
        self.resident_bytes = 0
        # counters (mirrored into RuntimeStats / PolicyReport by owners)
        self.places = 0
        self.hits = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.refetches = 0
        self.refetched_bytes = 0
        # multi-tenant binding: set by SharedDevicePool.attach()
        self.pool: Optional["SharedDevicePool"] = None
        self.owner: str = ""
        # keys evicted under pressure whose next placement is a refetch;
        # anchored keys clean themselves up when the anchor dies so id()
        # reuse cannot masquerade as a refetch.
        self._evicted: Dict[Hashable, Optional[weakref.ref]] = {}
        # keys whose versioned entry dropped with its anchor, with the
        # version it held: a later placement of the key at that version
        # moves the same memory again (read by a move's span, nothing
        # else; a new tensor born at a dropped key's address reads so too)
        self._dropped: "collections.OrderedDict[Hashable, int]" = (
            collections.OrderedDict())

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()

    def entry(self, key: Hashable) -> Optional[Entry]:
        return self._entries.get(key)

    # ------------------------------------------------------------------ #
    def get(self, key: Hashable):
        """Payload for ``key`` or None; a hit refreshes recency and the
        use count.  Entries whose anchor died (stale ``id()`` after GC)
        drop themselves and miss, exactly like the old registries."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            if ent.ref is not None and ent.ref() is None:
                self.drop(key)
                return None
            ent.uses += 1
            self._entries.move_to_end(key)
            self.hits += 1
            # hit events only matter for residency analysis under a cap —
            # uncapped runs (the default) would accumulate one event per
            # operand lookup forever for nothing, so they skip the record;
            # place/evict/refetch are rare and always emitted.
            if self.emit is not None and self.cap is not None:
                self.emit("hit", self.name, ent.nbytes)
            return ent.payload

    def put(self, key: Hashable, payload, nbytes: int, *,
            anchor=None, pinned: bool = False,
            version: Optional[int] = None) -> Entry:
        """Register a resident entry, then evict others over the cap.

        The runtime-registry admission semantic: the new entry is
        protected during the eviction sweep (its operand is in use by
        the current call), so a single oversized buffer is admitted and
        the *next* registration pushes it out.  ``version``: the
        anchor's version, which the store remembers for the key
        (:meth:`dropped_version`) if the anchor dies first.
        """
        with self._lock:
            if key in self._entries:
                self.drop(key)
            ref = None
            if anchor is not None:
                if version is None:
                    def _lifecycle(_ref, key=key, self=self):
                        self.drop(key)
                else:
                    def _lifecycle(_ref, key=key, self=self,
                                   version=version):
                        self._anchor_died(key, version)
                ref = weakref.ref(anchor, _lifecycle)
            ent = Entry(key=key, payload=payload, nbytes=int(nbytes),
                        pinned=pinned or self.pin_new, ref=ref)
            self._entries[key] = ent
            self.resident_bytes += ent.nbytes
            self.places += 1
            kind = "place"
            if key in self._evicted:
                del self._evicted[key]
                self.refetches += 1
                self.refetched_bytes += ent.nbytes
                kind = "refetch"
            if self.emit is not None:
                self.emit(kind, self.name, ent.nbytes)
            self.evict_over_cap(protect=key)
        # Charge the shared pool *after* releasing the store lock: the
        # pool may rebalance into other tenants' stores, and holding a
        # store lock while taking another store's lock would deadlock.
        if self.pool is not None:
            self.pool.charge(self.owner, ent.nbytes,
                             refetch=(kind == "refetch"))
        return ent

    def drop(self, key: Hashable) -> None:
        """Remove an entry without eviction accounting (lifecycle death,
        explicit invalidation, or re-registration)."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self.resident_bytes -= ent.nbytes
                if self.pool is not None:
                    self.pool.credit(self.owner, ent.nbytes)

    def _anchor_died(self, key: Hashable, version: int) -> None:
        """Drop ``key``'s entry, whose anchor died, remembering the
        version it was placed at (at most :data:`DROPPED_KEYS` keys)."""
        with self._lock:
            self._dropped[key] = version
            self._dropped.move_to_end(key)
            if len(self._dropped) > DROPPED_KEYS:
                self._dropped.popitem(last=False)
            self.drop(key)

    def dropped_version(self, key: Hashable) -> Optional[int]:
        """The version ``key``'s entry held when its anchor last died, or
        None where the store remembers no such drop."""
        return self._dropped.get(key)

    def refetching(self, key: Hashable) -> bool:
        """Whether placing ``key`` now counts as a refetch: pressure
        evicted it and it has not been placed since."""
        return key in self._evicted

    # ------------------------------------------------------------------ #
    # pinning                                                             #
    # ------------------------------------------------------------------ #
    def pin(self, key: Hashable) -> bool:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return False
            ent.pinned = True
            return True

    def unpin(self, key: Hashable) -> bool:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return False
            ent.pinned = False
            return True

    def pinned_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.pinned)

    # ------------------------------------------------------------------ #
    # eviction                                                            #
    # ------------------------------------------------------------------ #
    def _evict(self, key: Hashable) -> Entry:
        with self._lock:
            ent = self._entries.pop(key)
            self.resident_bytes -= ent.nbytes
            self.evictions += 1
            self.evicted_bytes += ent.nbytes
            # remember the key so its next placement counts as a refetch;
            # an anchored key forgets itself when the application's own
            # handle dies (a dead buffer can never be refetched).
            if ent.ref is not None and ent.ref() is not None:
                anchor = ent.ref()

                def _forget(_ref, key=key, self=self):
                    self._evicted.pop(key, None)
                self._evicted[key] = weakref.ref(anchor, _forget)
            else:
                self._evicted[key] = None
            if self.emit is not None:
                self.emit("evict", self.name, ent.nbytes)
            if self.on_evict is not None:
                self.on_evict(key, ent.payload, ent.nbytes)
            if self.pool is not None:
                self.pool.evicted(self.owner, ent.nbytes)
            return ent

    def evict_one(self) -> int:
        """Evict a single policy-chosen victim regardless of the local
        cap (shared-pool pressure from another tenant's placement).
        Returns the bytes freed, 0 when nothing is evictable — pinned
        entries survive pool pressure exactly as they survive cap
        pressure."""
        with self._lock:
            victim = self.policy.victim(self._entries, None)
            if victim is None:
                return 0
            return self._evict(victim).nbytes

    def evict_over_cap(self, protect: Optional[Hashable] = None) -> int:
        """Evict policy-chosen victims until resident bytes fit the cap
        (or nothing evictable remains).  Returns evictions performed."""
        if self.cap is None:
            return 0
        with self._lock:
            n = 0
            while self.resident_bytes > self.cap:
                victim = self.policy.victim(self._entries, protect)
                if victim is None:
                    break
                self._evict(victim)
                n += 1
            return n

    def evict_all(self) -> int:
        """Force-evict every entry through the normal eviction path —
        ``evict`` events, ``on_evict`` hooks and refetch tracking all
        run.  This is *invalidation*, not cap pressure: a quarantined
        device's residents are gone regardless of pin state (a pin can
        survive pressure, not a dead device).  Returns entries evicted.
        """
        with self._lock:
            n = 0
            for key in list(self._entries.keys()):
                if key in self._entries:      # a hook may drop siblings
                    self._evict(key)
                    n += 1
            return n

    def reserve(self, nbytes: int, *, limit: Optional[int] = None,
                evict: bool = True) -> bool:
        """HBM-capacity admission (the simulator's page-table semantic):
        make room for ``nbytes`` under ``limit`` (default: the cap) by
        evicting policy-chosen victims, or refuse — the caller leaves
        the buffer remote rather than thrashing residents for a block
        that cannot fit anyway."""
        with self._lock:
            limit = self.cap if limit is None else limit
            if limit is None:
                return True
            if self.resident_bytes + nbytes <= limit:
                return True
            if not evict:
                return False
            while self.resident_bytes + nbytes > limit:
                victim = self.policy.victim(self._entries, None)
                if victim is None:
                    return False
                self._evict(victim)
            return True

    # ------------------------------------------------------------------ #
    def clear(self) -> None:
        with self._lock:
            freed = self.resident_bytes
            self._entries.clear()
            self._evicted.clear()
            self._dropped.clear()
            self.resident_bytes = 0
            if self.pool is not None and freed:
                self.pool.credit(self.owner, freed)


# --------------------------------------------------------------------- #
# the shared multi-tenant pool                                           #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class _Tenant:
    """One pool member: its quota, live usage, and lifetime counters."""

    quota: Optional[int] = None
    usage: int = 0
    places: int = 0
    placed_bytes: int = 0
    evictions: int = 0
    evicted_bytes: int = 0
    refetches: int = 0
    stores: List[ResidencyStore] = dataclasses.field(default_factory=list)

    def row(self) -> dict:
        return {"quota": self.quota, "usage": self.usage,
                "places": self.places, "placed_bytes": self.placed_bytes,
                "evictions": self.evictions,
                "evicted_bytes": self.evicted_bytes,
                "refetches": self.refetches}


class SharedDevicePool:
    """One device-byte budget shared by many concurrent sessions.

    Each tenant (a :class:`~repro_torch.core.session.Session`'s runtime)
    registers with an optional per-tenant byte quota and attaches its
    residency stores.  Stores notify the pool on every placement,
    eviction and drop, so the pool's usage ledger mirrors the sum of
    tenant ``resident_bytes`` exactly — the concurrency test suite
    asserts that equality under a 32-thread storm.

    Pressure is resolved by :meth:`rebalance`, which runs after every
    charge:

    1. any tenant over its *own* quota is evicted down first, then
    2. while the *pool total* exceeds ``total_bytes``, the tenant with
       the highest ``usage / quota`` ratio loses one entry — fair,
       quota-proportional eviction (a tenant with 3x the quota settles
       at 3x the residency under uniform load).

    The victim plan is computed under the pool lock but the eviction
    itself runs outside it via the victim store's :meth:`evict_one`,
    preserving the store → pool lock order (never pool → store).
    Pinned entries are skipped by the policies, so a tenant whose
    residency is fully pinned is simply exempted from that sweep.
    """

    def __init__(self, total_bytes: Optional[int] = None, *,
                 name: str = "pool",
                 default_quota: Optional[int] = None):
        self.name = name
        self.total_bytes = total_bytes
        self.default_quota = default_quota
        self._lock = threading.RLock()
        self._members: Dict[str, _Tenant] = {}
        self._next_id = 0
        # pool-wide totals, maintained independently of the per-tenant
        # rows (the stress tests assert sum(tenants) == totals).
        self.places = 0
        self.placed_bytes = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.refetches = 0

    # ------------------------------------------------------------------ #
    # membership                                                          #
    # ------------------------------------------------------------------ #
    def register(self, session_id: str = "", *,
                 quota: Optional[int] = None) -> str:
        """Add a tenant; returns its (possibly auto-assigned) id."""
        with self._lock:
            sid = session_id
            if not sid:
                while True:
                    sid = f"tenant-{self._next_id}"
                    self._next_id += 1
                    if sid not in self._members:
                        break
            elif sid in self._members:
                raise ValueError(
                    f"session id {sid!r} already registered with "
                    f"pool {self.name!r}")
            self._members[sid] = _Tenant(
                quota=self.default_quota if quota is None else quota)
            return sid

    def attach(self, session_id: str, *stores: ResidencyStore) -> None:
        """Bind stores to a tenant: their placements charge the pool."""
        with self._lock:
            m = self._members[session_id]
            for s in stores:
                s.pool = self
                s.owner = session_id
                m.stores.append(s)
                m.usage += s.resident_bytes

    def unregister(self, session_id: str) -> None:
        """Detach a tenant's stores and forget its usage (session
        close); lifetime counters stay in the pool totals."""
        with self._lock:
            m = self._members.pop(session_id, None)
            if m is None:
                return
            for s in m.stores:
                s.pool = None
                s.owner = ""

    def members(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._members)

    def quota_of(self, session_id: str) -> Optional[int]:
        with self._lock:
            m = self._members.get(session_id)
            return None if m is None else m.quota

    def usage(self, session_id: Optional[str] = None) -> int:
        with self._lock:
            if session_id is not None:
                m = self._members.get(session_id)
                return 0 if m is None else m.usage
            return sum(m.usage for m in self._members.values())

    # ------------------------------------------------------------------ #
    # store notifications (store lock may be held; pool lock is inner)    #
    # ------------------------------------------------------------------ #
    def charge(self, owner: str, nbytes: int, *,
               refetch: bool = False) -> None:
        with self._lock:
            m = self._members.get(owner)
            if m is None:
                return
            m.usage += nbytes
            m.places += 1
            m.placed_bytes += nbytes
            self.places += 1
            self.placed_bytes += nbytes
            if refetch:
                m.refetches += 1
                self.refetches += 1
        self.rebalance()

    def credit(self, owner: str, nbytes: int) -> None:
        with self._lock:
            m = self._members.get(owner)
            if m is not None:
                m.usage -= nbytes

    def evicted(self, owner: str, nbytes: int) -> None:
        with self._lock:
            m = self._members.get(owner)
            if m is None:
                return
            m.usage -= nbytes
            m.evictions += 1
            m.evicted_bytes += nbytes
            self.evictions += 1
            self.evicted_bytes += nbytes

    # ------------------------------------------------------------------ #
    # pressure                                                            #
    # ------------------------------------------------------------------ #
    def _pick_victim(self, exclude) -> Optional[str]:
        # caller holds the pool lock
        for sid, m in self._members.items():
            if sid in exclude or not m.stores:
                continue
            if m.quota is not None and m.usage > m.quota:
                return sid
        if self.total_bytes is None:
            return None
        total = sum(m.usage for m in self._members.values())
        if total <= self.total_bytes:
            return None
        best, best_ratio = None, -1.0
        share = self.total_bytes / max(1, len(self._members))
        for sid, m in self._members.items():
            if sid in exclude or not m.stores or m.usage <= 0:
                continue
            denom = m.quota if m.quota else share
            ratio = m.usage / max(1.0, denom)
            if ratio > best_ratio:
                best, best_ratio = sid, ratio
        return best

    def rebalance(self) -> int:
        """Evict until every tenant fits its quota and the pool fits
        ``total_bytes`` (or nothing evictable remains).  Returns the
        number of entries evicted."""
        n = 0
        exhausted = set()
        while True:
            with self._lock:
                sid = self._pick_victim(exhausted)
                if sid is None:
                    return n
                stores = tuple(self._members[sid].stores)
            freed = 0
            for s in stores:       # outside the pool lock (store order)
                freed = s.evict_one()
                if freed:
                    n += 1
                    break
            if not freed:          # fully pinned / empty: exempt it
                exhausted.add(sid)

    # ------------------------------------------------------------------ #
    # reporting                                                           #
    # ------------------------------------------------------------------ #
    def tenant_stats(self) -> Dict[str, dict]:
        with self._lock:
            return {sid: m.row() for sid, m in self._members.items()}

    def report(self) -> str:
        with self._lock:
            cap = ("uncapped" if self.total_bytes is None
                   else f"{self.total_bytes}B")
            lines = [f"shared pool {self.name!r}: {len(self._members)} "
                     f"tenant(s), {self.usage_locked()}B / {cap}",
                     f"  totals: places={self.places} "
                     f"evictions={self.evictions} "
                     f"evicted_bytes={self.evicted_bytes} "
                     f"refetches={self.refetches}"]
            for sid, m in sorted(self._members.items()):
                quota = "none" if m.quota is None else f"{m.quota}B"
                lines.append(
                    f"  {sid:<16} usage={m.usage}B quota={quota} "
                    f"places={m.places} evictions={m.evictions} "
                    f"refetches={m.refetches}")
            return "\n".join(lines)

    def usage_locked(self) -> int:
        # caller holds the pool lock (RLock: safe either way)
        return sum(m.usage for m in self._members.values())


# --------------------------------------------------------------------- #
# the process-default pool (config-driven: SCILIB_POOL_BYTES/_QUOTA)     #
# --------------------------------------------------------------------- #
_DEFAULT_POOL: Optional[SharedDevicePool] = None
_DEFAULT_POOL_LOCK = threading.Lock()


def default_pool(total_bytes: Optional[int] = None) -> SharedDevicePool:
    """The lazily-created process-wide pool that config-driven sessions
    (``pool_bytes``/``pool_quota`` set, no explicit ``pool=``) join.
    The first caller's ``total_bytes`` wins; later values are ignored
    so concurrent openers agree on one budget."""
    global _DEFAULT_POOL
    with _DEFAULT_POOL_LOCK:
        if _DEFAULT_POOL is None:
            _DEFAULT_POOL = SharedDevicePool(total_bytes, name="default")
        return _DEFAULT_POOL


def reset_default_pool() -> None:
    """Drop the process-default pool (test isolation)."""
    global _DEFAULT_POOL
    with _DEFAULT_POOL_LOCK:
        _DEFAULT_POOL = None
