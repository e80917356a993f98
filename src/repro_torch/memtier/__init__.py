"""Tiered-memory hardware model (paper §2.1, §4.4).

The port's copy of ``repro/memtier``, numpy only (no torch).

This package models a unified-memory superchip as two NUMA domains —
host-resident memory (NUMA 0) and device-resident memory (NUMA 1) — with
asymmetric access bandwidths, a cache-coherent interconnect, page tables,
``move_pages``-style migration, and the hardware access-counter migration
whose behaviour the paper measures in §4.4.1.

Calibrated specs: ``GH200`` (the paper's machine, used to validate the
paper's claims), ``TPU_V5E`` (the reference's adaptation target used for
the roofline analysis) and ``H100`` (the port's card, from
``launch/calibrate.py``).
"""
from repro_torch.memtier.spec import (HardwareSpec, GH200, TPU_V5E,
                                      GH200_4K, H100, MemKind)
from repro_torch.memtier.pagetable import PageTable, Buffer
from repro_torch.memtier.simulator import (
    MemTierSimulator,
    PolicyReport,
    replay_trace,
)

__all__ = [
    "HardwareSpec",
    "GH200",
    "GH200_4K",
    "TPU_V5E",
    "H100",
    "MemKind",
    "PageTable",
    "Buffer",
    "MemTierSimulator",
    "PolicyReport",
    "replay_trace",
]
