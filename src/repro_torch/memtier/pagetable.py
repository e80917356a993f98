"""Virtual-memory page table with NUMA placement and ``move_pages``.

The port's copy of ``repro/memtier/pagetable.py``, unchanged (numpy
only).

Models Figure 2 of the paper: a buffer is a range of virtual pages whose
physical pages can be re-homed between the host NUMA domain and the device
NUMA domain *without changing the virtual addresses the application sees*.
That property is what makes the Device First-Use policy implementable under
an unmodified binary, and here it is what lets the simulator account
byte-exactly for which accesses hit which memory.

Granularity note (DESIGN.md §2): the production JAX runtime migrates whole
buffers; this page-level model exists to reproduce the paper's page-size,
alignment and partial-migration studies (Tables 6-8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.memtier.spec import HardwareSpec, MemKind


@dataclasses.dataclass
class Buffer:
    """A virtual allocation: contiguous range of pages + bookkeeping."""

    buf_id: int
    name: str
    base: int                  # virtual byte address
    size: int                  # bytes
    page_size: int
    aligned: bool              # base % page_size == 0
    # Physical placement per page (MemKind values).
    numa: np.ndarray = dataclasses.field(repr=False, default=None)
    # Device read-access counter per page (models Hopper's access counter).
    dev_reads: np.ndarray = dataclasses.field(repr=False, default=None)
    # Statistics for the paper's reuse analysis (§4.2: "reused 780 times").
    device_uses: int = 0       # kernel uses while fully device-resident
    migrations: int = 0        # page-migration events (any direction)
    bytes_migrated: int = 0

    # O(1) residency bookkeeping (updated by PageTable.move_pages)
    dev_pages: int = 0

    def __post_init__(self):
        if self.numa is None:
            self.numa = np.full(self.n_pages, MemKind.HOST, dtype=np.int8)
        if self.dev_reads is None:
            self.dev_reads = np.zeros(self.n_pages, dtype=np.int64)

    @property
    def n_pages(self) -> int:
        first = self.base - (self.base % self.page_size)
        last = self.base + self.size
        return int(-(-(last - first) // self.page_size))

    def resident_bytes(self, kind: MemKind) -> int:
        frac = self.dev_pages / max(1, self.n_pages)
        if kind == MemKind.HOST:
            frac = 1.0 - frac
        return int(round(frac * self.size))

    def fully_on(self, kind: MemKind) -> bool:
        if kind == MemKind.DEVICE:
            return self.dev_pages == self.n_pages
        return self.dev_pages == 0


class PageTable:
    """Tracks buffers, placement and NUMA capacity for one superchip."""

    def __init__(self, spec: HardwareSpec):
        self.spec = spec
        self.buffers: Dict[int, Buffer] = {}
        self._next_id = 1
        self._brk = spec.page_size  # bump allocator virtual cursor
        self.used: Dict[MemKind, int] = {MemKind.HOST: 0, MemKind.DEVICE: 0}

    # ------------------------------------------------------------------ #
    # allocation                                                          #
    # ------------------------------------------------------------------ #
    def malloc(self, size: int, name: str = "", *,
               align_to_page: Optional[bool] = None) -> Buffer:
        """Allocate on the host NUMA domain (malloc is a CPU-side call).

        glibc malloc page-aligns big allocations via mmap but offsets them
        by a header; the paper's Table 8 shows that offset costs ~40 % on
        device kernels. ``align_to_page`` defaults to False to model plain
        malloc; the aligned case models posix_memalign.
        """
        ps = self.spec.page_size
        if align_to_page is None:
            align_to_page = False
        base = -(-self._brk // ps) * ps
        if not align_to_page:
            base += 16  # malloc header offset -> not page aligned
        buf = Buffer(self._next_id, name or f"buf{self._next_id}",
                     base, size, ps, aligned=(base % ps == 0))
        self._next_id += 1
        self._brk = base + size + ps
        self.buffers[buf.buf_id] = buf
        self.used[MemKind.HOST] += buf.n_pages * ps
        return buf

    # ------------------------------------------------------------------ #
    # migration                                                           #
    # ------------------------------------------------------------------ #
    def move_pages(self, buf: Buffer, target: MemKind,
                   pages: Optional[np.ndarray] = None) -> Tuple[int, float]:
        """Re-home pages; returns (bytes_moved, seconds).

        Mirrors Linux ``move_pages(2)``: physical copy over the link plus
        per-page kernel bookkeeping; virtual addresses are untouched.
        """
        spec = self.spec
        # fast path: whole-buffer moves with O(1) counters
        if pages is None and buf.fully_on(target):
            return 0, 0.0
        mask = (buf.numa != int(target))
        if pages is not None:
            sel = np.zeros_like(mask)
            sel[pages] = True
            mask &= sel
        n = int(np.count_nonzero(mask))
        if n == 0:
            return 0, 0.0
        moved_bytes = n * buf.page_size
        src = MemKind.HOST if target == MemKind.DEVICE else MemKind.DEVICE
        self.used[src] -= moved_bytes
        self.used[target] += moved_bytes
        buf.numa[mask] = int(target)
        buf.dev_pages = int(np.count_nonzero(buf.numa == int(MemKind.DEVICE)))
        buf.migrations += 1
        buf.bytes_migrated += moved_bytes
        secs = moved_bytes / spec.effective_migrate_bw() \
            + n * spec.migrate_page_s
        return moved_bytes, secs

    # ------------------------------------------------------------------ #
    # access accounting                                                   #
    # ------------------------------------------------------------------ #
    def stream_time(self, buf: Buffer, bytes_touched: int, *,
                    accessor: str) -> float:
        """Seconds to stream ``bytes_touched`` of ``buf`` for an accessor.

        Splits the traffic by current page residency and charges each slice
        at the measured bandwidth for that (accessor, location) pair.
        """
        spec = self.spec
        dev_frac = buf.resident_bytes(MemKind.DEVICE) / max(1, buf.size)
        dev_bytes = bytes_touched * dev_frac
        host_bytes = bytes_touched - dev_bytes
        if accessor == "gpu":
            t = dev_bytes / spec.gpu_local_bw + host_bytes / spec.gpu_remote_bw
        elif accessor == "cpu":
            remote = spec.cpu_remote_bw
            if spec.page_size >= 64 * 1024:
                remote = remote / spec.cpu_remote_64k_penalty
            t = host_bytes / spec.cpu_local_bw + dev_bytes / remote
        else:
            raise ValueError(f"unknown accessor {accessor!r}")
        return t

    def record_device_reads(self, buf: Buffer, reads_per_elem: float) -> None:
        """Bump the Hopper-style access counters on host-resident pages."""
        if buf.dev_pages == buf.n_pages:
            return
        # O(1) summary counter; the per-page array is only materialized
        # for buffers that stay partially resident (none in our traces)
        buf.dev_reads[0] += max(1, int(reads_per_elem))

    # ------------------------------------------------------------------ #
    # stats                                                               #
    # ------------------------------------------------------------------ #
    def device_bytes_used(self) -> int:
        return self.used[MemKind.DEVICE]

    def reuse_report(self) -> Dict[str, float]:
        migrated = [b for b in self.buffers.values() if b.bytes_migrated > 0]
        if not migrated:
            return {"n_migrated_buffers": 0, "mean_reuse": 0.0}
        uses = [b.device_uses for b in migrated]
        return {
            "n_migrated_buffers": len(migrated),
            "mean_reuse": float(np.mean(uses)),
            "max_reuse": float(np.max(uses)),
            "total_bytes_migrated": float(sum(b.bytes_migrated
                                              for b in migrated)),
        }
