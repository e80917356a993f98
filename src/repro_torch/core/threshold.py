"""Offload-threshold logic (paper §3.3); a copy of ``repro/core/threshold.py``.

Small matrix math stays on the host: the paper's default is
``N_avg > 500`` where ``N_avg`` is a routine-dependent geometric-mean
dimension — for ``C = A x B``, ``N_avg = (M·N·K)^(1/3)``. The constant is
device-dependent; 500 is the paper's conservative Grace-Hopper value, and
it can be overridden per-process with ``SCILIB_THRESHOLD`` exactly like the
original tool's environment knob.
"""
from __future__ import annotations

from typing import Tuple

DEFAULT_THRESHOLD = 500.0

#: Per-device safe lower bounds (the paper: "the optimal threshold is
#: GPU-dependent"). v5e MXU pipelines saturate earlier for bf16 than H100
#: FP64 tensor cores, but dispatch overheads are comparable.  Keys are
#: the canonical device keys :func:`detect_device_key` produces.
DEVICE_DEFAULTS = {
    "gh200": 500.0,
    "tpu-v5e": 384.0,
    "tpu": 384.0,     # other TPU generations: same MXU-saturation regime
    "gpu": 500.0,     # unknown CUDA/ROCm parts: the paper's safe value
    "cpu": 500.0,     # no accelerator: value only matters for simulation
}


def detect_device_key(backend: str = None, device_kind: str = None) -> str:
    """Canonical device key for DEVICE_DEFAULTS from the live backend.

    ``backend``/``device_kind`` exist for tests; by default they come from
    PyTorch: ``"gpu"`` with ``torch.cuda.get_device_name(0)`` when CUDA is
    available, else ``"cpu"``.  An H100 maps to ``"gpu"`` (500) until the
    threshold is measured on the card.
    """
    if backend is None or device_kind is None:
        import torch
        cuda = torch.cuda.is_available()
        if backend is None:
            backend = "gpu" if cuda else "cpu"
        if device_kind is None:
            device_kind = torch.cuda.get_device_name(0) if cuda else ""
    kind = (device_kind or "").lower()
    if backend == "tpu":
        return "tpu-v5e" if "v5" in kind else "tpu"
    if backend == "gpu":
        return "gh200" if ("gh200" in kind or "grace" in kind) else "gpu"
    return backend


def default_threshold() -> float:
    """Backend-detected threshold default (``OffloadConfig.threshold``
    and ``SCILIB_THRESHOLD`` override it)."""
    return DEVICE_DEFAULTS.get(detect_device_key(), DEFAULT_THRESHOLD)


def threshold_from_env(default: float = DEFAULT_THRESHOLD) -> float:
    """The ``SCILIB_THRESHOLD`` override read through the config boundary
    (:meth:`repro_torch.core.config.OffloadConfig.from_env`), else
    ``default``.  The runtime itself takes its config's ``threshold``."""
    from repro_torch.core.config import OffloadConfig
    t = OffloadConfig.from_env().threshold
    return default if t is None else t


def base_routine(routine: str) -> str:
    """Routine family without the precision prefix (``"dsyrk"`` ->
    ``"syrk"``).  Not ``lstrip("sdcz")``: that also eats the base's own
    leading ``s`` (``"dsyrk"`` -> ``"yrk"``) and broke the syrk/symm
    branches below for every precision."""
    return routine[1:] if routine[:1] in ("s", "d", "c", "z") else routine


def n_avg(routine: str, m: int, n: int, k: int = 0) -> float:
    """Routine-dependent mean dimension (paper §3.3)."""
    base = base_routine(routine)
    m, n, k = max(1, m), max(1, n), max(1, k)
    if base == "gemm":
        return (m * n * k) ** (1.0 / 3.0)
    if base in ("trsm", "trmm", "symm", "hemm"):
        # A is m x m, applied to an m x n panel.
        return (m * m * n) ** (1.0 / 3.0)
    if base in ("syrk", "herk", "syr2k", "her2k"):
        return (n * n * k) ** (1.0 / 3.0)
    return (m * n * max(k, 1)) ** (1.0 / 3.0)


def should_offload(routine: str, m: int, n: int, k: int = 0, *,
                   threshold: float = DEFAULT_THRESHOLD,
                   batch: int = 1) -> Tuple[bool, float]:
    """Offload decision. Batched calls amortize launch cost, so the batch
    size enters through the cube root (equivalent total-work heuristic)."""
    nav = n_avg(routine, m, n, k) * (max(1, batch) ** (1.0 / 3.0))
    return nav > threshold, nav


def threshold_grid(n_avgs, limit: int = 8) -> Tuple[float, ...]:
    """Candidate thresholds for a workload's observed N_avg values.

    The only thresholds worth trying are the ones that flip at least one
    call's decision: midpoints between adjacent distinct N_avg values,
    plus one below the smallest and one above the largest, plus the
    paper's default.  Deduplicated, sorted, and capped at ``limit``
    (evenly subsampled) so autotune grids stay small on ragged traces.
    """
    uniq = sorted({round(float(v), 3) for v in n_avgs if v > 0})
    cands = {DEFAULT_THRESHOLD}
    if uniq:
        cands.add(max(1.0, uniq[0] * 0.5))
        cands.add(uniq[-1] * 2.0)
        for lo, hi in zip(uniq, uniq[1:]):
            cands.add((lo + hi) / 2.0)
    grid = sorted(cands)
    if len(grid) > limit:
        step = (len(grid) - 1) / (limit - 1)
        grid = [grid[round(i * step)] for i in range(limit)]
    return tuple(grid)
