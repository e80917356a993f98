"""Hardware specifications for tiered-memory systems.

The port's copy of ``repro/memtier/spec.py``, unchanged: the specs
are the paper's GH200 and the reference's TPU v5e; no H100 spec is
added here.

Constants for GH200 come from the paper's own measurements:

* Table 1 (STREAM): CPU->LPDDR5X 418-446 GB/s, CPU->HBM3 ~142 GB/s,
  GPU->HBM3 3.36-3.68 TB/s, GPU->LPDDR5X 407-610 GB/s.
* NVLink-C2C: 450 GB/s per direction (paper §2.1).
* Table 8: cublasDgemm on unaligned system-malloc HBM is ~1.35-1.47x slower
  than page-aligned; Table 3 shows the same effect at application level
  (DFU zgemm+ztrsm 580 s vs Mem-Copy-on-cudaMalloc 439.8 s ~= 1.32x).

TPU v5e constants are the roofline constants mandated for this repo:
197 TFLOP/s bf16 per chip, 819 GB/s HBM, ~50 GB/s/link ICI; host link is
PCIe-class.
"""
from __future__ import annotations

import dataclasses
import enum


class MemKind(enum.IntEnum):
    """NUMA domain of a page/buffer (paper §2.1: two NUMA domains)."""

    HOST = 0    # CPU-resident (LPDDR5X on GH200; host DRAM for TPU)
    DEVICE = 1  # device-resident (HBM3 on GH200; HBM on TPU)


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Bandwidths (bytes/s), compute rates (FLOP/s) and page parameters.

    ``*_bw`` names read as ``<accessor>_<location>``: e.g. ``gpu_remote_bw``
    is the device engine streaming operands that still reside in host memory
    (over the coherent link).
    """

    name: str

    # --- streaming bandwidths (bytes/s) -------------------------------
    cpu_local_bw: float      # CPU <- host memory
    cpu_remote_bw: float     # CPU <- device memory (slow path, Table 1)
    gpu_local_bw: float      # device <- HBM
    gpu_remote_bw: float     # device <- host memory over coherent link
    link_bw: float           # explicit copy/migration engine, per direction

    # --- compute (FLOP/s, achievable not peak) -------------------------
    cpu_flops: float         # host BLAS (e.g. NVPL dgemm on 72c Grace)
    gpu_flops: float         # device BLAS (cuBLAS dgemm on H100 / MXU)
    # Per-routine efficiency at production (mid-size, mixed-shape) calls.
    # Calibrated so Table 3's cudaMalloc zgemm+ztrsm time reproduces:
    # LU-stream gemms run well below peak (decreasing trailing sizes,
    # launch gaps), trsm panels far below, and the CPU panel factor
    # (getf2, never offloaded) is memory-bound rank-1 work.
    gpu_eff: tuple = (("gemm", 0.55), ("trsm", 0.25), ("syrk", 0.5),
                      ("symm", 0.55), ("trmm", 0.4), ("getf2", 0.0))
    cpu_eff: tuple = (("gemm", 0.85), ("trsm", 0.6), ("getf2", 0.25))

    # --- overheads ------------------------------------------------------
    kernel_launch_s: float = 4.0e-6   # per device-kernel launch
    migrate_page_s: float = 1.2e-6    # per-page move_pages() bookkeeping
    migrate_bw: float = 0.0           # effective move_pages throughput;
                                      # defaults to link_bw when 0

    # --- memory geometry -------------------------------------------------
    page_size: int = 64 * 1024        # 64 KB default on GH200 (paper §4.4.2)
    host_capacity: int = 120 << 30
    device_capacity: int = 96 << 30

    # --- pathologies measured by the paper ------------------------------
    # §4.4.3 / Table 8: device kernels on system-malloc'd, non-page-aligned
    # device memory run ~1.35-1.47x slower than on page-aligned memory.
    unaligned_penalty: float = 1.40
    # Residual penalty for system-allocated device memory even when the
    # allocator page-aligns large blocks (Table 3: 580 s vs 439.8 s).
    sysmalloc_penalty: float = 1.30
    # §4.4.2 Table 7: CPU access to device memory degrades further at 64K
    # pages (15.5 ms vs 10.9 ms -> ~1.4x applied to cpu_remote paths).
    cpu_remote_64k_penalty: float = 1.40

    def effective_migrate_bw(self) -> float:
        return self.migrate_bw if self.migrate_bw > 0 else self.link_bw

    def eff(self, accessor: str, routine: str) -> float:
        base = routine.lstrip("sdcz")
        table = dict(self.gpu_eff if accessor == "gpu" else self.cpu_eff)
        return table.get(base, 1.0)

    def with_(self, **kw) -> "HardwareSpec":
        return dataclasses.replace(self, **kw)


GB = 1.0e9
TB = 1.0e12

# The paper's machine: Vista GH200 node (120 GB LPDDR5X Grace + 96 GB H100).
GH200 = HardwareSpec(
    name="gh200",
    cpu_local_bw=418.22 * GB,     # Table 1 CPU triad on LPDDR5X
    cpu_remote_bw=141.94 * GB,    # Table 1 CPU triad on HBM3
    gpu_local_bw=3679.50 * GB,    # Table 1 GPU triad on HBM3
    gpu_remote_bw=610.43 * GB,    # Table 1 GPU triad on LPDDR5X via C2C
    link_bw=450.0 * GB,           # NVLink-C2C per direction (§2.1)
    # CPU baseline = Grace-Grace NODE (144 cores, Table 3's comparison
    # unit): ~6.2 TF/s peak FP64, per-routine eff applied on top.
    cpu_flops=6.2e12,
    # H100 cuBLAS dgemm sustained FP64 (tensor core): ~55 TF/s.
    gpu_flops=55.0e12,
    migrate_bw=300.0 * GB,        # move_pages sustained < raw C2C
    page_size=64 * 1024,
)

# Same machine booted with 4 KB base pages (paper §4.4.2 tests both).
GH200_4K = GH200.with_(name="gh200-4k", page_size=4 * 1024,
                       cpu_remote_64k_penalty=1.0)

# Adaptation target for the LM framework rooflines.
TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    cpu_local_bw=200.0 * GB,
    cpu_remote_bw=16.0 * GB,      # host reads of HBM are indirect
    gpu_local_bw=819.0 * GB,      # HBM bw per chip (mandated constant)
    gpu_remote_bw=32.0 * GB,      # PCIe-class host link: no coherent C2C
    link_bw=32.0 * GB,
    cpu_flops=2.0e12,
    gpu_flops=197.0e12,           # bf16 MXU (mandated constant)
    page_size=32 * 1024,          # model granule: one VMEM tile row
    host_capacity=512 << 30,
    device_capacity=16 << 30,
    # No coherent-malloc pathology on TPU; placement is always explicit.
    unaligned_penalty=1.0,
    sysmalloc_penalty=1.0,
    cpu_remote_64k_penalty=1.0,
)

SPECS = {s.name: s for s in (GH200, GH200_4K, TPU_V5E)}
