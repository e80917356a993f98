#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the main path
gives it, then drives the main path through the entry points a user
calls: intercepted BLAS under Device First-Use (``repro_torch.session``
with ``host_array`` inputs), then the LSMS KKR loop
(``repro_torch.apps.lsms.run_mini``) at the production KKR size
n = 6912 in complex128.  Phases, in order:

1. build   — build and load the kernels; the card's name and power limit.
2. kernels — each kernel against its plain version, with the tolerance
             stated beside it; kernel, plain and library times.
3. blas    — gemm/trsm/small mm inside a DFU session; counters asserted.
4. lsms    — run_mini(atoms=2, energies=2, scf=1, n=6912, complex128)
             inside the same session; counters, residual and launches
             asserted.

Every mismatch or missing launch raises, so the script exits non-zero.
The lines before the last are a JSON object of per-kernel numbers and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the port
beside it, the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_OPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

#: tolerances on max|kernel - plain| / max|plain| and why:
#: float64 — both sum in float64; K*eps64 ~ 8e-13 at K = 6912 leaves room
#: float32 — IEEE float32 on both sides: sqrt(K)*eps32 ~ 1.4e-6 at K = 513
#:           is expected; TF32 (10-bit mantissa) would land near 1e-3
#: bfloat16 — float32 sums, one bf16 rounding of the output (2^-8 = 3.9e-3)
#:            that the two sides may take in different directions
TOL = {"float64": 1e-10, "float32": 1e-4, "bfloat16": 5e-2}
#: trsm float32: the triangles are diagonally dominant (condition ~1), so
#: the error is the substitution's rounding, m*eps32 ~ 2e-5 at m = 300
TRSM_TOL = {"float64": 1e-10, "float32": 3e-4}
#: LSMS residual max|M tau - t|: LU with partial pivoting is backward
#: stable, |r| <~ n*eps64*|M||tau| ~ 8e-13 at n = 6912 for M ~ I; 1e-9
#: leaves a thousandfold margin and still catches a float32 path (~1e-4)
LSMS_RESID = 1e-9


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` from CUDA events over ``reps`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple:
    import torch
    diff = (got.to(want.dtype) - want).abs().max().item()
    scale = want.abs().max().item()
    return diff, diff / scale if scale else diff


def check(name: str, got, want, tol: float) -> float:
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    diff, rel = rel_err(got, want)
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {tol:g}")
    log("kernels", f"{name}: rel err {rel:.3e} (tol {tol:g})")
    return diff


def bound(ops: float, nbytes: float, dtype: str) -> tuple:
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tri(gen, n: int, uplo: str, dtype, device):
    """A diagonally dominant triangle, as in tests/test_kernels.py."""
    import torch
    a = torch.randn(n, n, generator=gen, dtype=torch.float64) / n
    a = a.tril() if uplo == "L" else a.triu()
    a.diagonal().copy_(1.0 + a.diagonal().abs())
    return a.to(dtype).to(device)


def phase_build():
    from repro_torch.kernels import compat
    t0 = time.perf_counter()
    paths = compat.build_all()
    secs = time.perf_counter() - t0
    for name, path in sorted(paths.items()):
        regs = [ln.strip()
                for ln in compat.BUILD_LOG.get(name, "").splitlines()
                if "registers" in ln or "spill" in ln]
        log("build", f"{name}: {path.name} {'; '.join(sorted(set(regs)))}")
    log("build", f"card: {card_line()}; build {secs:.1f} s "
                 f"(nvcc {compat.BUILD_SECONDS:.1f} s)")


def gemm_times(a, b, label: str) -> dict:
    """Kernel, plain-version and torch.matmul times of one product, with
    its bound: 2*M*N*K operations, and each operand read once and the
    result written once."""
    import torch
    from repro_torch.kernels import gemm
    (m, k), n = a.shape, b.shape[1]
    dt = str(a.dtype)[6:]
    ms = time_ms(lambda: gemm.gemm(a, b), reps=5)
    plain_ms = time_ms(lambda: gemm.gemm_plain(a, b), reps=5)
    lib_ms = time_ms(lambda: torch.matmul(a, b), reps=5)
    bms, by = bound(2.0 * m * n * k,
                    a.element_size() * (m * k + k * n + m * n), dt)
    log("kernels", f"gemm {dt} {label}: kernel {ms:.3f} ms "
                   f"({2 * m * n * k / ms / 1e9:.1f} TFLOP/s), plain "
                   f"{plain_ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, "
                   f"bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def trsm_times(a, b, label: str, plain_reps: int) -> dict:
    """The same for a lower-left solve: m*m*n operations; the triangle
    read once, B read once, X written once."""
    from repro_torch.kernels import ref, trsm
    m, n = b.shape
    ms = time_ms(lambda: trsm.trsm(a, b), reps=5)
    plain_ms = time_ms(lambda: trsm.trsm_plain(a, b), reps=plain_reps)
    lib_ms = time_ms(lambda: ref.trsm(a, b), reps=5)
    bms, by = bound(float(m) * m * n,
                    a.element_size() * (m * (m + 1) / 2 + 2 * m * n),
                    str(a.dtype)[6:])
    log("kernels", f"trsm {str(a.dtype)[6:]} {label}: kernel {ms:.3f} ms, "
                   f"plain {plain_ms:.3f} ms, solve_triangular "
                   f"{lib_ms:.3f} ms, bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def phase_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels import gemm, ops, ref, trsm
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen,
                           dtype=torch.float64).to(dtype).to(dev)

    # gemm at a ragged shape in each type
    m, n, k = 1000, 777, 513
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        a, b = rnd(m, k, dtype=dt), rnd(k, n, dtype=dt)
        check(f"gemm {str(dt)[6:]} {m}x{n}x{k}", gemm.gemm(a, b),
              gemm.gemm_plain(a, b), TOL[str(dt)[6:]])
        gemm_times(a, b, f"{m}x{n}x{k}")
    # the BLAS phase's float32 product
    a, b = rnd(4096, 4096, dtype=torch.float32), rnd(4096, 4096,
                                                     dtype=torch.float32)
    check("gemm float32 4096^3", gemm.gemm(a, b), gemm.gemm_plain(a, b),
          TOL["float32"])
    gemm_times(a, b, "4096^3")
    # one real plane of the LSMS zgemm
    N = 6912
    a, b = rnd(N, N), rnd(N, N)
    gemm_err = check(f"gemm float64 {N}^3", gemm.gemm(a, b),
                     gemm.gemm_plain(a, b), TOL["float64"])
    gemm_row = dict(name="gemm", route="cuda",
                    source="src/repro_torch/csrc/gemm.cu",
                    replaces="src/repro/kernels/gemm.py:26",
                    max_abs_err=gemm_err,
                    **gemm_times(a, b, f"{N}^3 (one LSMS plane)"))
    del a, b
    za = torch.complex(rnd(N, N), rnd(N, N))
    zb = torch.complex(rnd(N, N), rnd(N, N))
    check(f"ops.matmul complex128 {N}^3 (4M)", ops.matmul(za, zb),
          ref.matmul(za, zb), TOL["float64"])
    ms = time_ms(lambda: ops.matmul(za, zb), reps=3)
    lib_ms = time_ms(lambda: torch.matmul(za, zb), reps=3)
    log("kernels", f"ops.matmul complex128 {N}^3 (4M, 4 launches + plane "
                   f"copies): {ms:.3f} ms, torch.matmul (zgemm) "
                   f"{lib_ms:.3f} ms")
    del za, zb

    # trsm: every variant at m = 300 (the recursion runs), both types
    for dt in (torch.float32, torch.float64):
        worst = 0.0
        for side in "LR":
            for uplo in "LU":
                for tr in "NTC":
                    for dg in "NU":
                        a = tri(gen, 300, uplo, dt, dev)
                        b = (rnd(300, 40, dtype=dt) if side == "L"
                             else rnd(40, 300, dtype=dt))
                        kw = dict(side=side, uplo=uplo, trans=tr, diag=dg)
                        got = trsm.trsm(a, b, **kw)
                        want = trsm.trsm_plain(a, b, **kw)
                        _, rel = rel_err(got, want)
                        if not rel <= TRSM_TOL[str(dt)[6:]]:
                            raise AssertionError(
                                f"trsm {dt} {kw}: rel err {rel:.3e}")
                        worst = max(worst, rel)
        log("kernels", f"trsm {str(dt)[6:]} m=300: 24 variants (side x "
                       f"uplo x trans N/T/C x diag), worst rel err "
                       f"{worst:.3e} (tol {TRSM_TOL[str(dt)[6:]]:g})")
    a, b = tri(gen, 300, "L", torch.float64, dev), rnd(300, 40)
    trsm_times(a, b, "300x40", plain_reps=3)
    M, R = 6912, 32
    a, b = tri(gen, M, "L", torch.float64, dev), rnd(M, R)
    trsm_err = check(f"trsm float64 {M}x{R}", trsm.trsm(a, b),
                     trsm.trsm_plain(a, b), TRSM_TOL["float64"])
    trsm_row = dict(name="trsm", route="cuda",
                    source="src/repro_torch/csrc/trsm.cu",
                    replaces="src/repro/kernels/trsm.py:32",
                    max_abs_err=trsm_err,
                    **trsm_times(a, b, f"{M}x{R}", plain_reps=2))
    return {"gemm": gemm_row, "trsm": trsm_row}


def reset_counts() -> None:
    from repro_torch.kernels import gemm, trsm
    gemm.reset_launches()
    trsm.reset_launches()


def counts() -> dict:
    from repro_torch.kernels import gemm, trsm
    return {"gemm": gemm.launches, "trsm": trsm.launches}


def phase_blas(s, dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import blas, host_array
    from repro_torch.kernels import ref
    rng = np.random.default_rng(1)
    n = 4096
    a, b, c = (host_array(rng.standard_normal((n, n)), torch.float32)
               for _ in range(3))
    tm = host_array(np.tril(rng.standard_normal((6912, 6912)) / 6912)
                    + 2.0 * np.eye(6912), torch.float64)
    rhs = host_array(rng.standard_normal((6912, 32)), torch.float64)
    small_a, small_b = (host_array(rng.standard_normal((64, 64)),
                                   torch.float32) for _ in range(2))
    reset_counts()
    out1 = blas.gemm(a, b, c, alpha=1.5, beta=-0.5, trans_a="T")
    out2 = blas.gemm(a, b, c, alpha=1.5, beta=-0.5, trans_a="T")
    x = blas.trsm(tm, rhs)
    small = torch.mm(small_a, small_b)
    s.sync()
    launched = counts()
    st = s.stats.per_routine
    sg, dt = st["sgemm"], st["dtrsm"]
    want = (sg.calls, sg.offloaded, sg.on_host, sg.bytes_in,
            sg.cache_hits, dt.calls, dt.offloaded, dt.bytes_in)
    expect = (3, 2, 1, 3 * n * n * 4, 3, 1, 1, (6912 * 6912 + 6912 * 32) * 8)
    if want != expect:
        raise AssertionError(f"blas counters {want} != {expect}")
    if sg.transient_bytes != 2 * 64 * 64 * 4:
        raise AssertionError(f"small mm streamed {sg.transient_bytes} B")
    if launched["gemm"] < 3 or launched["trsm"] < 1:
        raise AssertionError(f"blas launches {launched}")
    ad, bd, cd = a.to(dev), b.to(dev), c.to(dev)
    plain = 1.5 * ref.matmul(ad.mT.contiguous(), bd) - 0.5 * cd
    for name, got in (("gemm call 1", out1), ("gemm call 2", out2)):
        diff, rel = rel_err(got, plain)
        if not rel <= TOL["float32"]:
            raise AssertionError(f"blas {name}: rel err {rel:.3e}")
    diff, rel = rel_err(x, ref.trsm(tm.to(dev), rhs.to(dev)))
    if not rel <= TRSM_TOL["float64"]:
        raise AssertionError(f"blas trsm: rel err {rel:.3e}")
    diff, rel = rel_err(small, ref.matmul(small_a.to(dev), small_b.to(dev)))
    if not rel <= TOL["float32"]:
        raise AssertionError(f"blas small mm: rel err {rel:.3e}")
    log("blas", f"sgemm calls={sg.calls} offloaded={sg.offloaded} "
                f"on_host={sg.on_host} bytes_in={sg.bytes_in} (second "
                f"call moved 0 B, {sg.cache_hits} residency hits); dtrsm "
                f"bytes_in={dt.bytes_in}; launches {launched}; results "
                f"within tolerance")
    return launched


def phase_lsms(s, dev, n: int = 6912) -> dict:
    import torch
    import repro_torch
    from repro_torch import OffloadConfig
    from repro_torch.apps import lsms
    # small input first: the card against the CPU reference path
    with repro_torch.session(OffloadConfig(policy="dfu", threshold=100.0),
                             device="cpu"):
        cpu = lsms.run_mini(atoms=2, energies=2, scf=1, n=192,
                            device="cpu")
    with repro_torch.session(OffloadConfig(policy="dfu", threshold=100.0),
                             device=dev):
        gpu = lsms.run_mini(atoms=2, energies=2, scf=1, n=192, device=dev)
    if not abs(gpu["energy"] - cpu["energy"]) <= 1e-10:
        raise AssertionError(f"lsms n=192: energy {gpu['energy']!r} on the "
                             f"card vs {cpu['energy']!r} on the CPU")
    log("lsms", f"n=192: energy {gpu['energy']:.12f} on the card, "
                f"{cpu['energy']:.12f} on the CPU")
    # the production KKR size, inside the main session, timed per call
    atoms, energies = 2, 2
    s.reconfigure(sync=True)
    reset_counts()
    t0 = time.perf_counter()
    out = lsms.run_mini(atoms=atoms, energies=energies, scf=1, n=n,
                        dtype=torch.complex128, device=dev)
    s.sync()
    wall = time.perf_counter() - t0
    launched = counts()
    z = s.stats.per_routine["zgemm"]
    if (z.calls, z.offloaded) != (4, 4):
        raise AssertionError(f"zgemm calls/offloaded {z.calls}/"
                             f"{z.offloaded} != 4/4")
    if z.bytes_in != atoms * n * n * 16:
        raise AssertionError(f"zgemm moved {z.bytes_in} B, want G once per "
                             f"atom ({atoms * n * n * 16} B)")
    if z.cache_hits != atoms * (energies - 1):
        raise AssertionError(f"zgemm residency hits {z.cache_hits} != "
                             f"{atoms * (energies - 1)}")
    if not (math.isfinite(out["energy"])
            and out["max_resid"] < LSMS_RESID):
        raise AssertionError(f"lsms result {out}")
    if launched["gemm"] < 16:
        raise AssertionError(f"lsms gemm launches {launched['gemm']} < 16")
    log("lsms", f"n={n}: energy {out['energy']:.12f}, max_resid "
                f"{out['max_resid']:.3e} (bound {LSMS_RESID:g}), zgemm "
                f"{z.seconds / z.calls:.4f} s per call (synchronized), "
                f"bytes_in {z.bytes_in} (G once per atom), residency hits "
                f"{z.cache_hits}, launches {launched}, loop wall {wall:.2f} s")
    for line in s.report().splitlines():
        log("lsms", line)
    return launched


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this "
              "script; run it from a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this check runs on "
              "the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch import OffloadConfig

    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    torch.cuda.synchronize()
    with repro_torch.session(OffloadConfig(policy="dfu",
                                           threshold=500.0)) as s:
        blas_launches = phase_blas(s, dev)
        lsms_launches = phase_lsms(s, dev)
    for name, row in rows.items():
        row["launches"] = blas_launches[name] + lsms_launches[name]
        if row["launches"] == 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 f"main path")
    log("done", f"peak device memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: rows[n][k] for k in keys}
                                  for n in ("gemm", "trsm")]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
