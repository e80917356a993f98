"""Three-term roofline model from a dry run's counts (no hardware needed).

The counterpart of ``repro/roofline/analysis.py``:

    compute    = FLOPs / peak FLOP/s        (per chip)
    memory     = bytes / HBM bandwidth      (per chip)
    collective = collective bytes / link bandwidth

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
collective bytes from the optimized HLO text (:func:`collective_bytes`,
copied here so that both parse the same text alike).  The port's dry run
(:mod:`repro_torch.launch.dryrun`) counts them on each rank's local ops
instead; :func:`collective_bytes_of` files its collective log under the
HLO op names.

Hardware constants: :data:`V5E` (TPU v5e, the reference's, unchanged) and
:data:`H100` (NVIDIA H100 SXM5 data sheet: 989 TFLOP/s bf16 dense,
67 TFLOP/s float64 on the tensor cores, 3.35 TB/s of HBM3, 80 GB; NVLink
4 at 900 GB/s over 18 links, so 50 GB/s per link).  The link term of
``H100`` has not been measured: the card's machine has one card.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Optional, Tuple

V5E = {
    "peak_flops": 197.0e12,     # bf16 per chip
    "hbm_bw": 819.0e9,          # bytes/s per chip
    "link_bw": 50.0e9,          # bytes/s per ICI link
    "hbm_bytes": 16 << 30,
}

H100 = {
    "peak_flops": 989.0e12,     # bf16 dense per card
    "peak_flops_f64": 67.0e12,  # float64 on the tensor cores
    "hbm_bw": 3.35e12,          # bytes/s, HBM3
    "link_bw": 50.0e9,          # bytes/s per NVLink 4 link (900 GB/s / 18)
    "hbm_bytes": 80 * 10**9,
}

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "all-to-all", "collective-permute")

# one shaped value, e.g. "bf16[16,4096,320]{2,1,0}"
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        numel = 1
        if dims:
            for d in dims.split(","):
                numel *= int(d)
        total += numel * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum result-shape bytes of every collective op, by op kind.

    HLO line form: ``%name = <shape> <op>(...)``: the result shape of a
    collective equals the payload living on the wire for AG/AR/CP; for
    reduce-scatter the *operand* is bigger, but the ring transfers the
    result-sized shards, so result bytes are the honest wire estimate.
    """
    out: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        s = line.strip()
        if not s or "=" not in s:
            continue
        m = re.match(r"%?[\w.\-]+\s*=\s*(.+)$", s)
        if not m:
            continue
        rhs = m.group(1)
        for coll in _COLLECTIVES:
            # match the op name at the call position
            mm = re.match(r"^((?:\([^)]*\))|(?:[\w\[\]{},: ]+?))\s*"
                          + re.escape(coll) + r"(?:-start)?\(", rhs)
            if mm:
                nbytes = _shape_bytes(mm.group(1))
                out[coll] = out.get(coll, 0) + nbytes
                break
    return out


def collective_bytes_of(log: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """The port's counterpart of :func:`collective_bytes`: sums a dry
    run's collective log, ``(kind, result bytes)`` per collective a rank
    issued, by kind."""
    out: Dict[str, int] = {}
    for kind, nbytes in log:
        out[kind] = out.get(kind, 0) + int(nbytes)
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    model_flops: float               # 6·N·D (or 6·N_active·D)
    spec: Dict = dataclasses.field(default_factory=lambda: V5E)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0

    def __post_init__(self):
        self.t_compute = self.flops_per_chip / self.spec["peak_flops"]
        self.t_memory = self.bytes_per_chip / self.spec["hbm_bw"]
        self.t_collective = self.coll_bytes_per_chip / self.spec["link_bw"]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap bound: the max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        total_hlo = self.flops_per_chip * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term bound that is useful model math:
        (model_flops/chips/peak) / step_time."""
        ideal = self.model_flops / self.chips / self.spec["peak_flops"]
        return ideal / self.step_time if self.step_time else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "dominant": self.dominant,
            "useful_flops_ratio": round(self.useful_ratio, 4),
            "roofline_fraction": round(self.roofline_fraction, 4),
        }


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                   cost: Optional[dict], hlo_text: str,
                   model_flops: float,
                   coll_bytes: Optional[float] = None,
                   spec: Optional[Dict] = None) -> RooflineReport:
    cost = cost or {}
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    if coll_bytes is None:
        coll_bytes = float(sum(collective_bytes(hlo_text).values()))
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, bytes_per_chip=nbytes,
        coll_bytes_per_chip=coll_bytes,
        model_flops=model_flops, spec=spec or V5E)
