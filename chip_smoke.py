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
n = 6912 in complex128, then the same loop and the real dense solvers
through the LAPACK solver tier (``OffloadConfig(lapack=True)``, the
patched ``torch.linalg`` symbols), then the kernel venue, adaptive
per-site racing and split-precision fp64 at PARSEC's production shapes
(ngrid 93536, nstates 2400, nblock 32), then the serving loop
(``repro_torch.train.Server``) on gemma2-9b at full width with a Device
First-Use decode cache.  Phases, in order:

1. build   — build and load the kernels; the card's name and power limit.
2. kernels — each kernel against its plain version, with the tolerance
             stated beside it; kernel, plain and library times; gemm on
             each of its paths, at the serve path's bf16 shapes too
             (prefill MLP, decode projections, the vocab head over the
             table's transposed view); trsm in every variant, ragged,
             batched and on an LU factor, one launch per solve; syrk
             float64 on DMMA at PARSEC's shape with its K split plan,
             two calls bit for bit; the fused split kernel's slices bit
             for bit, its exact-pass check and dropped-pass controls;
             flash attention on its wgmma path at the serve shape (each
             call repeated and held bit for bit to the first) and at
             head sizes 128 and 64 in bf16 and f16, and on its FMA path
             in float32 at the serve shape and in bf16 at head size 32;
             decode attention at the serve shape, one launch, kv_len by
             value and on the device bit for bit, 100 repeats held to
             the first; gemm and trsm at the solver tier's shapes, and
             the library's complex trsm there.
3. blas    — gemm/trsm/small mm inside a DFU session; counters and one
             trsm launch asserted.
4. lsms    — run_mini(atoms=2, energies=2, scf=1, n=6912, complex128)
             inside the same session; counters, residual and launches
             asserted; the loop's wall split into intercepted BLAS time
             and the rest.
5. solvers — one DFU session with lapack=True, lapack_nb 256: (a) the
             LSMS loop again, its LU now the tier's blocked getrf/getrs
             spans (span counts, panels, residual, energy against the
             native LU's, G moved once per atom; each span's time split
             into panels, zgemm and ztrsm, beside cuSOLVER's); (b)
             torch.linalg.solve and cholesky + cholesky_solve in float64
             at n 6912 (backward error), eigh at n 2400 (residual,
             orthogonality, eigenvalues); (c) the session's trace
             replayed by the port's memtier simulator to the live
             per-solver counters, and the autotuner's recommendation.
6. venue   — (a) kernel_path + adaptive: 8 calls of blas.syrk(psi,
             trans="T") at one call site race host/xla/pallas and lock;
             (b) kernel_path + precision="auto": intercepted
             torch.matmul(hpsi_blk.T, psi) runs split3 on the pallas
             venue, within its a-priori bound; (c) a cancelling dgemm
             escalates to native fp64.  One session each.
7. runtime — the rest of the runtime: (a) the tile scheduler over 4
             tiers of the card (OffloadConfig(devices=4)): LSMS's zgemm
             at n 6912 twice (4 tiles, 2 blocks of 382.2 MB moved per
             tier, then only affinity hits), its trsm against 256
             columns (4 panels, the triangle on every tier, 4 trsm.cu
             launches), and on the pallas venue PARSEC's split3
             projection and syrk (tiles on split_gemm.cu and gemm.cu),
             each against the same call on one tier, the trace replayed
             on 4 tiers; (b) faults: the (a) sequence under injected
             transfer and kernel faults, bit for bit the clean run's; the
             breaker walk (3 fallbacks, a quarantine, degraded calls, the
             half-open probe's recovery); a real OOM under a memory
             fraction (the breaker's quarantine frees a placement and
             the fallback streams into that room); (c) tenancy: 3 threads,
             each a named session on one 2 GiB SharedDevicePool, the
             ledger sampled between calls, cross-tenant evictions,
             allocator growth, results bit for bit each tenant's serial
             run.  Every phase that injects nothing asserts zero faults,
             retries, fallbacks and quarantines.
8. serve   — gemma2-9b (42 layers, d_model 3584, vocab 256000, bf16,
             prefill_fresh_kv) with seeded random weights, batch 2 x
             4608 prompt tokens: generate 16 under dfu and 4 under
             memcopy (every attention kernel call there also held to its
             plain version), byte/migration/reuse counts and kernel
             launches asserted, every flash launch on the wgmma path;
             (d) launch/serve.py's streams path: 2 worker threads over
             the shared weights, each stream's 8 tokens equal the dfu
             run's first 8; then, at the same widths over 2 layers,
             a forward without a cache over the prompt and 15 generated
             tokens against the cached steps' logits; a device profile
             of one prefill and one decode step.

The kernels line's launches are those of the main path's runs: the
BLAS, LSMS and solvers phases, the venue phase's (a)-(c), every run of
the runtime phase, and the serve phase's dfu, streams and memcopy runs,
each with the counts set to 0 just before it.  The cross-check's and the profile's launches are not among them.
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
#: the special-function units (ex2, rcp): 16 a clock on each of 132 SMs
#: at ~1.83 GHz, the rate FlashAttention-3 gives for the H100
PEAK_MUFU = 3.9e12

#: tolerances on max|kernel - plain| / max|plain| and why:
#: float64 — both sum in float64; K*eps64 ~ 8e-13 at K = 6912 leaves room
#: float32 — IEEE float32 on both sides: sqrt(K)*eps32 ~ 1.4e-6 at K = 513
#:           is expected; TF32 (10-bit mantissa) would land near 1e-3
#: bfloat16 — float32 sums, one bf16 rounding of the output (2^-8 = 3.9e-3)
#:            that the two sides may take in different directions
TOL = {"float64": 1e-10, "float32": 1e-4, "bfloat16": 5e-2}
#: trsm float32: the triangles are diagonally dominant (condition ~1), so
#: the error is the solve's rounding, m*eps32 ~ 2e-5 at m = 300
TRSM_TOL = {"float64": 1e-10, "float32": 3e-4}
#: trsm on the unit-lower factor of torch.linalg.lu_factor(randn(2048)):
#: not diagonally dominant (condition in the thousands), so against
#: solve_triangular the limit is 20 * cond(L) * eps64: a backward-stable
#: solve's forward error is ~cond(L) * eps times a modest factor, for the
#: kernel's inverted diagonal blocks as for substitution
TRSM_LU_FACTOR = 20
TRSM_LU_M = 2048
#: LSMS residual max|M tau - t|: LU with partial pivoting is backward
#: stable, |r| <~ n*eps64*|M||tau| ~ 8e-13 at n = 6912 for M ~ I; 1e-9
#: leaves a thousandfold margin and still catches a float32 path (~1e-4)
LSMS_RESID = 1e-9
#: the solvers phase: the production LU block size (repro_torch.apps.lsms
#: PROD["nb"]), the energy of LSMS through the solver tier against the
#: lsms phase's native LU on the same matrices (two float64 LUs of M ~ I:
#: both energies carry ~n*eps64 ~ 1e-12 of rounding, so 1e-9 relative
#: leaves a thousandfold margin)
SOLVER_NB = 256
LSMS_ENERGY_RTOL = 1e-9
#: normwise backward error |A x - b|_inf / (|A|_inf |x|_inf) of the
#: real tier's solves: LU with partial pivoting and Cholesky are backward
#: stable, with an error of a modest multiple of n * eps64 in theory and
#: ~eps64 in practice on random matrices; 4 n eps64 = 3.1e-12 at n = 6912,
#: eps64 the unit roundoff 2^-53
SOLVE_BERR_FACTOR = 4
EPS64 = 2.0 ** -53
#: eigh at PARSEC's Rayleigh-Ritz size (nstates): Householder
#: tridiagonalization is backward stable, |A S - S diag(w)|_1 and
#: |S^T S - I|_1 ~ n eps64 |A|_1 = 5e-13 |A|_1 at n = 2400 (the port's
#: syev reads 7e-15 and 2e-13 at this size on the CPU); 1e-11 leaves a
#: twentyfold margin over the larger
EIGH_TOL = 1e-11
#: PARSEC's production shapes (src/repro_torch/apps/dft.py PROD)
NGRID, NSTATES, NBLOCK = 93536, 2400, 32
#: launches of csrc/split_gemm.cu per split product: the fused passes,
#: then the fixed-order sum of the K-split partials
SPLIT3_LAUNCHES = 2
#: an escalated result against native fp64: both are float64 sums of the
#: same terms in different orders (the gemm kernel's DMMA tiles against
#: cuBLAS's); 1e-12 absolute on a product that cancels to ~1e-15 leaves
#: room for any summation order
ESCALATED_TOL = 1e-12
#: gemma2-9b's projection shapes on the serve path: the prefill's MLP
#: (M = batch x prompt), a decode step's (M = batch), and the tied vocab
#: head's K and N
SERVE_D, SERVE_FF, SERVE_VOCAB = 3584, 14336, 256000
#: split3 on exact-pass operands (exact_pass_operands) against their
#: exact product, column-relative: a few float64 roundings of the pass
#: sum read ~1.2e-15 on the CPU, any pass left out reads 1.5e-8 or more
#: (tests/test_torch_precision.py)
EXACT_PASS_TOL = 1e-12
#: flash and decode attention in bf16 against their plain versions on the
#: same bf16 inputs, per query row: max|kernel - plain| / max|plain| along
#: the head dim, the largest over rows (row_rel).  Both sides compute in
#: float32 (online against full softmax, other summation orders: ~1e-5 of
#: a row at logits of ~100), then each rounds its output to bf16 once; two
#: roundings of nearly equal values differ by at most one bf16 ulp, 2^-7 =
#: 7.8e-3 of the value and so of the row's largest
ATTN_TOL = 1e-2
#: the kernels phase scales randn q by this, so that the logits q.k / 16
#: have a standard deviation of ~30 and softcap 50 bites: the largest of a
#: row's ~4600 logits, ~100, caps to 48.2, and its runner-up, ~96, to
#: 47.9, so the cap spreads the weight over tens of keys
ATTN_Q_SCALE = 30.0
#: repeats of each serve-shape flash call, and of the decode call, held
#: bit for bit against the first: each kernel's arithmetic order is fixed,
#: so a race in a pipeline's barriers or in the decode kernel's tickets
#: would show as a difference
FLASH_REPEATS = 100
#: gemma2-9b serve cell: batch, prompt (past the 4096 window), generation
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 4608, 16
SERVE_LEN = SERVE_PROMPT + SERVE_GEN
#: its decode cache: 2 period positions x (k, v), each (21 groups, batch,
#: 8 KV heads, SERVE_LEN slots, head size 256) in bf16
SERVE_CACHE_BYTES = 4 * 21 * SERVE_BATCH * 8 * SERVE_LEN * 256 * 2
assert SERVE_CACHE_BYTES == 3_181_903_872
#: profiles taken by device_ms before an empty one is an error
PROFILE_TRIES = 3


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


def device_events(prof) -> list:
    """(name, microseconds) of each device event (kernel, copy, memset)
    that a torch.profiler run recorded.  Only device events: an
    operator's device time would count its kernels twice."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` from torch.profiler over ``reps``
    calls: the summed duration of every device event, divided by
    ``reps``.  Unlike
    time_ms it leaves out the host's time between launches, which for a
    call of tens of microseconds can exceed the device's own.  A profile
    that records no device event at all is taken again, up to
    ``PROFILE_TRIES`` times in all (the card's profiler has once returned
    an empty trace for a window in which the calls ran); raises if every
    try records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(us for _, us in device_events(prof))
        if total > 0:
            if attempt > 1:
                log("profile", f"device events recorded on try {attempt} "
                               f"of {PROFILE_TRIES}")
            return total / 1e3 / reps
    raise RuntimeError(f"device_ms: the profiler recorded no device event "
                       f"in {PROFILE_TRIES} tries")


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


def row_rel(got, want) -> float:
    """The largest over rows of max|got - want| / max|want| along the
    last dim: attention's error measure, where rows (query positions and
    heads) differ in magnitude."""
    import torch
    g, w = got.float(), want.float()
    den = w.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - w).abs().amax(-1) / den).max().item()


def check_rows(name: str, got, want, tol: float) -> float:
    """``check`` for attention, with the error per row (row_rel)."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    rel = row_rel(got, want)
    if not rel <= tol:
        raise AssertionError(f"{name}: per-row relative error {rel:.3e} > "
                             f"{tol:g}")
    log("kernels", f"{name}: per-row rel err {rel:.3e} (tol {tol:g})")
    return (got.float() - want.float()).abs().max().item()


def control(name: str, got, want, tol: float) -> None:
    """A negative control: ``got`` computes another function than
    ``want``, and the check must see it (per-row error over ``tol``)."""
    rel = row_rel(got, want)
    if not rel > tol:
        raise AssertionError(f"control {name}: per-row relative error "
                             f"{rel:.3e} <= {tol:g}; the check cannot tell "
                             f"the two apart")
    log("kernels", f"control {name}: per-row rel err {rel:.3e} > {tol:g}, "
                   f"as it must be")


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


def wgmma_waits(lib: Path) -> list:
    """Per wgmma kernel of a built library, from its SASS (cuobjdump):
    the wgmma instructions and the warpgroup waits among them.  As many
    waits as wgmma means ptxas serialized them (it does so around a
    spill, or a branch or a register write inside a wgmma region)."""
    import re
    from repro_torch.kernels import compat
    cuobjdump = Path(compat.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = []
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0]
        mma = len(re.findall(r"\bHGMMA\.", func))
        if mma:
            out.append((compat.kernel_name(name.strip()), mma,
                        len(re.findall(r"WARPGROUP\.DEPBAR", func))))
    return out


def phase_build():
    from repro_torch.kernels import compat
    t0 = time.perf_counter()
    paths = compat.build_all()
    secs = time.perf_counter() - t0
    for name, path in sorted(paths.items()):
        log("build", f"{name}: {path.name}")
        for v in compat.ptxas_variants(compat.BUILD_LOG.get(name, "")):
            log("build", f"  {v['name']}: {v.get('regs')} registers, "
                         f"{v.get('smem')} B smem, {v['stack']} B stack, "
                         f"{v['spill']} B spill stores, {v.get('blocks')} "
                         f"blocks of 256 threads per SM")
        for kernel, mma, waits in wgmma_waits(path):
            log("build", f"  {kernel}: {mma} wgmma, {waits} warpgroup waits"
                         + (" (serialized)" if waits >= mma else ""))
    import torch
    log("build", f"card: {card_line()}; build {secs:.1f} s "
                 f"(nvcc {compat.BUILD_SECONDS:.1f} s); torch "
                 f"{torch.__version__}, CUDA {torch.version.cuda}")


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


def serve_gemm_checks(dev) -> None:
    """gemm at the serve path's bf16 shapes against its plain version,
    with kernel, plain, torch.matmul and bound times: the prefill's MLP
    (path 1, tensor cores), decode projections (path 2, K split across
    blocks), the tied vocab head over the table's transposed view (path
    2, dot products along K, no copy), and ragged controls of both
    paths."""
    import torch
    from repro_torch.kernels import gemm
    gen = torch.Generator(device=dev).manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    m_pre = SERVE_BATCH * SERVE_PROMPT
    w_ff, w_kv = rnd(SERVE_D, SERVE_FF), rnd(SERVE_D, 2048)
    table = rnd(SERVE_VOCAB, SERVE_D)
    x = rnd(SERVE_BATCH, SERVE_D)
    cases = [
        (f"prefill MLP {m_pre}x{SERVE_FF}x{SERVE_D}", rnd(m_pre, SERVE_D),
         w_ff),
        (f"decode MLP {SERVE_BATCH}x{SERVE_FF}x{SERVE_D}", x, w_ff),
        (f"decode k/v {SERVE_BATCH}x2048x{SERVE_D}", x, w_kv),
        (f"vocab head {SERVE_BATCH}x{SERVE_VOCAB}x{SERVE_D} (table.mT)", x,
         table.mT),
        ("ragged 200x93x170", rnd(200, 170), rnd(170, 93)),
        ("ragged 130x200x136 (B transposed)", rnd(130, 136),
         rnd(200, 136).mT),
        ("ragged 3x200x136", rnd(3, 136), rnd(136, 200)),
    ]
    for label, a, b in cases:
        p = gemm.plan(a, b)
        label = f"{label}, path {p.path}, splits {p.splits}"
        check(f"gemm bfloat16 {label}", gemm.gemm(a, b),
              gemm.gemm_plain(a, b), TOL["bfloat16"])
        gemm_times(a, b, label)
    del w_ff, w_kv, table


def trsm_times(a, b, label: str, plain_reps: int, **kw) -> dict:
    """The same for a triangular solve (lower-left unless ``kw`` says
    otherwise): mt*mt*r operations for a triangle of order mt and r
    right-hand sides; the triangle read once, B read once, X written
    once.  The plain version is the kernel's block-row order
    (trsm_dataflow_plain); each timed kernel call is one launch after
    one memset of its flags."""
    from repro_torch.kernels import ref, trsm
    mt = a.shape[-1]
    r = b.numel() // mt
    ms = time_ms(lambda: trsm.trsm(a, b, **kw), reps=5)
    plain_ms = time_ms(lambda: trsm.trsm_dataflow_plain(a, b, **kw),
                       reps=plain_reps)
    lib_ms = time_ms(lambda: ref.trsm(a, b, **kw), reps=5)
    bms, by = bound(float(mt) * mt * r,
                    a.element_size() * (mt * (mt + 1) / 2 + 2 * mt * r),
                    str(a.dtype)[6:])
    log("kernels", f"trsm {str(a.dtype)[6:]} {label}: kernel {ms:.3f} ms "
                   f"({trsm.units(mt, r, 1)} blocks, one launch), "
                   f"plain {plain_ms:.3f} ms, solve_triangular "
                   f"{lib_ms:.3f} ms, bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def phase_kernels_tier(dev, gen) -> None:
    """gemm and trsm at the shapes the solver tier gives them (the
    solvers phase), each against its plain version with kernel, plain,
    library and bound times: the f64 DMMA path at getrf's first trailing
    update plane at nb 256 (6656 x 6656 x 256); trsm at potrf's first
    right-side solve (X L^H = B, B 6656 x 256) and at getrs's upper
    non-unit 6912 x 32.  Complex trsm is the library's on the card
    (kernels/ops.py), as XLA's in the reference: its times at getrf's
    unit-lower 256 x 6656 and getrs's 6912 x 6912 x 6912 are library
    rows, with their bound."""
    import torch
    from repro_torch.kernels import gemm, ref, trsm
    n, nb = 6912, SOLVER_NB
    m = n - nb

    def rnd(*shape):
        return torch.randn(*shape, generator=gen,
                           dtype=torch.float64).to(dev)
    a, b = rnd(m, nb), rnd(nb, m)
    label = f"{m}x{m}x{nb} (getrf's first trailing update plane)"
    check(f"gemm float64 {label}", gemm.gemm(a, b), gemm.gemm_plain(a, b),
          TOL["float64"])
    gemm_times(a, b, label)
    del a, b
    for tri_n, uplo, b, kw, label in (
            (nb, "L", rnd(m, nb), dict(side="R", uplo="L", trans="C"),
             f"{m}x{nb} side R lower C (potrf's first panel solve)"),
            (n, "U", rnd(n, 32), dict(uplo="U"),
             f"{n}x32 upper non-unit (getrs's second solve)")):
        t = tri(gen, tri_n, uplo, torch.float64, dev)
        check(f"trsm float64 {label}", trsm_one(t, b, label, **kw),
              trsm.trsm_dataflow_plain(t, b, **kw), TRSM_TOL["float64"])
        trsm_times(t, b, label, plain_reps=2, **kw)
    for tri_n, cols, reps, label in (
            (nb, m, 5, f"{nb}x{m} unit lower (getrf's panel row)"),
            (n, n, 2, f"{n}x{n}x{n} unit lower (getrs's solve)")):
        t = torch.complex(tri(gen, tri_n, "L", torch.float64, dev),
                          tri(gen, tri_n, "L", torch.float64, dev))
        b = torch.complex(rnd(tri_n, cols), rnd(tri_n, cols))
        ms = time_ms(lambda: ref.trsm(t, b, diag="U"), reps=reps)
        bms, by = bound(4.0 * tri_n * tri_n * cols,
                        16 * (tri_n * (tri_n + 1) / 2 + 2 * tri_n * cols),
                        "float64")
        log("kernels", f"ztrsm complex128 {label}: solve_triangular (the "
                       f"library, no kernel) {ms:.3f} ms, bound {bms:.4f} "
                       f"ms ({by}), {bms / ms:.1%} of it")
        del t, b


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
    serve_gemm_checks(dev)

    rows = {"gemm": gemm_row, "trsm": phase_kernels_trsm(dev, gen)}
    phase_kernels_tier(dev, gen)
    rows.update(phase_kernels_parsec(dev, gen))
    rows.update(phase_kernels_attention(dev))
    return rows


def trsm_one(a, b, name: str, **kw):
    """One solve on the kernel, asserted to be one launch after one memset
    of its flags."""
    from repro_torch.kernels import trsm
    launched, memsets = trsm.launches, trsm.memsets
    got = trsm.trsm(a, b, **kw)
    if (trsm.launches - launched, trsm.memsets - memsets) != (1, 1):
        raise AssertionError(f"trsm {name}: {trsm.launches - launched} "
                             f"launches and {trsm.memsets - memsets} "
                             f"memsets, want 1 and 1")
    return got


def phase_kernels_trsm(dev, gen) -> dict:
    """trsm against the kernel's block-row order (trsm_dataflow_plain):
    every variant (side x uplo x trans N/T/C x diag) in both types at m =
    300, n = 40 (five block rows, two panels) and at m = 1, 63, 64, 65; a
    batched solve; an LU factor's unit-lower triangle against
    solve_triangular; then the BLAS phase's 6912 x 32 solve, timed."""
    import torch
    from repro_torch.kernels import trsm

    def rnd(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen,
                           dtype=torch.float64).to(dtype).to(dev)
    for dt in (torch.float32, torch.float64):
        tol = TRSM_TOL[str(dt)[6:]]
        worst, cases = 0.0, 0
        for m, n in ((300, 40), (1, 40), (63, 40), (64, 40), (65, 40)):
            for side in "LR":
                for uplo in "LU":
                    for tr in "NTC":
                        for dg in "NU":
                            a = tri(gen, m, uplo, dt, dev)
                            b = (rnd(m, n, dtype=dt) if side == "L"
                                 else rnd(n, m, dtype=dt))
                            kw = dict(side=side, uplo=uplo, trans=tr,
                                      diag=dg)
                            got = trsm_one(a, b, f"{dt} m={m} {kw}", **kw)
                            want = trsm.trsm_dataflow_plain(a, b, **kw)
                            _, rel = rel_err(got, want)
                            if not rel <= tol:
                                raise AssertionError(
                                    f"trsm {dt} m={m} {kw}: rel err "
                                    f"{rel:.3e} > {tol:g}")
                            worst, cases = max(worst, rel), cases + 1
        a = torch.stack([tri(gen, 300, "L", dt, dev) for _ in range(3)])
        b = rnd(3, 300, 40, dtype=dt)
        got = trsm_one(a, b, f"{dt} batched 3 x 300 x 40", trans="T")
        _, rel = rel_err(got, trsm.trsm_dataflow_plain(a, b, trans="T"))
        if not rel <= tol:
            raise AssertionError(f"trsm {dt} batched: rel err {rel:.3e}")
        log("kernels", f"trsm {str(dt)[6:]}: {cases} solves (24 variants "
                       f"at m = 300, 1, 63, 64, 65) and a batched one, one "
                       f"launch each, worst rel err {max(worst, rel):.3e} "
                       f"vs the kernel's plain order (tol {tol:g})")
    lu, _ = torch.linalg.lu_factor(rnd(TRSM_LU_M, TRSM_LU_M))
    lf = lu.tril(-1) + torch.eye(TRSM_LU_M, dtype=lu.dtype, device=dev)
    b = rnd(TRSM_LU_M, 32)
    cond = torch.linalg.cond(lf).item()
    tol = TRSM_LU_FACTOR * cond * torch.finfo(torch.float64).eps
    got = trsm_one(lu, b, "LU factor", diag="U")
    _, rel = rel_err(got, torch.linalg.solve_triangular(
        lf, b, upper=False, unitriangular=True))
    if not rel <= tol:
        raise AssertionError(f"trsm LU factor: rel err {rel:.3e} > {tol:.3e}")
    log("kernels", f"trsm float64 on the unit-lower factor of lu_factor("
                   f"randn({TRSM_LU_M})), cond {cond:.3e}: rel err {rel:.3e} "
                   f"vs solve_triangular (tol {TRSM_LU_FACTOR} cond eps64 = "
                   f"{tol:.3e})")
    del lu, lf
    a, b = tri(gen, 300, "L", torch.float64, dev), rnd(300, 40)
    trsm_times(a, b, "300x40", plain_reps=3)
    M, R = 6912, 32
    a, b = tri(gen, M, "L", torch.float64, dev), rnd(M, R)
    err = check(f"trsm float64 {M}x{R}", trsm_one(a, b, f"{M}x{R}"),
                trsm.trsm_dataflow_plain(a, b), TRSM_TOL["float64"])
    return dict(name="trsm", route="cuda",
                source="src/repro_torch/csrc/trsm.cu",
                replaces="src/repro/kernels/trsm.py:32", max_abs_err=err,
                **trsm_times(a, b, f"{M}x{R}", plain_reps=2))


def syrk_times(psi) -> dict:
    """Kernel, plain-version and library times of the PARSEC Gram matrix
    C = Psi^T Psi (lower triangle), with its bound: n(n+1)k operations,
    Psi read once and C written once.  The library has no syrk: its time
    is torch.matmul(Psi^T, Psi), the full product, twice the operations."""
    import torch
    from repro_torch.kernels import syrk
    k, n = psi.shape
    p = syrk.plan(n, k, psi.dtype, "T")
    first = syrk.syrk(psi, trans="T")
    if not torch.equal(syrk.syrk(psi, trans="T"), first):
        raise AssertionError("syrk float64: two calls on the same Psi differ")
    del first
    log("kernels", f"syrk float64 n={n} k={k}: {p.tiles} tiles of "
                   f"{p.edge}, K split {p.splits} ways ({p.chunk} each), "
                   f"{p.blocks} blocks, {p.waves:.2f} waves on "
                   f"{syrk.SMS} SMs; two calls equal bit for bit")
    ms = time_ms(lambda: syrk.syrk(psi, trans="T"), reps=5)
    plain_ms = time_ms(lambda: syrk.syrk_plain(psi, trans="T"), reps=5)
    lib_ms = time_ms(lambda: torch.matmul(psi.mT, psi), reps=5)
    bms, by = bound(float(n) * (n + 1) * k, 8.0 * (n * k + n * n),
                    "float64")
    log("kernels", f"syrk float64 n={n} k={k} trans T: kernel {ms:.3f} ms "
                   f"({n * (n + 1) * k / ms / 1e9:.1f} TFLOP/s), plain "
                   f"{plain_ms:.3f} ms, torch.matmul full product "
                   f"{lib_ms:.3f} ms (2x the operations), bound {bms:.4f} "
                   f"ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def split_times(a, b) -> dict:
    """Times of one split3 dgemm A @ B at the PARSEC projection shape:
    the fused split kernel, the plain version (the same passes as
    float32 torch.matmul, the `xla` venue's formulation) and native
    torch.matmul dgemm.  The bound is that of the function, the float64
    product: 2MNK operations at the float64 peak against each operand
    read once and C written once.  What this algorithm spends (6 float32
    passes of 2MNK) is logged beside it, not used as the bound."""
    import torch
    from repro_torch.core import precision
    from repro_torch.kernels import split_gemm
    (m, k), n = a.shape, b.shape[1]
    ms = time_ms(lambda: split_gemm.matmul(a, b, "split3"), reps=3)
    plain_ms = time_ms(lambda: precision.matmul(a, b, "split3"), reps=3)
    lib_ms = time_ms(lambda: torch.matmul(a, b), reps=5)
    bms, by = bound(2.0 * m * n * k, 8.0 * (m * k + k * n + m * n),
                    "float64")
    log("kernels", f"split3 dgemm {m}x{n}x{k}: {SPLIT3_LAUNCHES} "
                   f"split_gemm.cu launches (K split "
                   f"{split_gemm.splits_for(m, n, k)} ways) {ms:.3f} ms, "
                   f"plain (float32 torch.matmul "
                   f"passes) {plain_ms:.3f} ms, native torch.matmul dgemm "
                   f"{lib_ms:.3f} ms, bound {bms:.4f} ms ({by}; the six "
                   f"float32 passes' own operations would take "
                   f"{6 * 2.0 * m * n * k / PEAK_OPS['float32'] * 1e3:.4f}"
                   f" ms at the float32 peak)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def phase_kernels_parsec(dev, gen) -> dict:
    """The syrk kernel and the split passes against their plain versions
    at PARSEC's production shapes, plus ragged float32 syrk shapes."""
    import torch
    from repro_torch.core import precision
    from repro_torch.kernels import ref, split_gemm, syrk
    # ragged float32 syrk in both layouts and triangles
    worst = 0.0
    for tr in "NT":
        for up in "LU":
            a = torch.randn(1000, 513, generator=gen).to(dev)
            a = a if tr == "N" else a.mT.contiguous()
            got = syrk.syrk(a, uplo=up, trans=tr)
            _, rel = rel_err(got, syrk.syrk_plain(a, uplo=up, trans=tr))
            if not rel <= TOL["float32"]:
                raise AssertionError(f"syrk float32 {tr}{up}: rel err "
                                     f"{rel:.3e}")
            worst = max(worst, rel)
    log("kernels", f"syrk float32 n=1000 k=513: trans N/T x uplo L/U, "
                   f"worst rel err {worst:.3e} (tol {TOL['float32']:g})")
    dgen = torch.Generator(device=dev).manual_seed(1)
    psi = torch.randn(NGRID, NSTATES, generator=dgen, dtype=torch.float64,
                      device=dev)
    syrk_err = check(f"syrk float64 n={NSTATES} k={NGRID} trans T (PARSEC "
                     f"Gram)", syrk.syrk(psi, trans="T"),
                     syrk.syrk_plain(psi, trans="T"), TOL["float64"])
    syrk_row = dict(name="syrk", route="cuda",
                    source="src/repro_torch/csrc/syrk.cu",
                    replaces="src/repro/kernels/syrk.py:21",
                    max_abs_err=syrk_err, **syrk_times(psi))
    # the split passes: S_blk = Hpsi_blk^T Psi, M=32, N=2400, K=93536
    blk = torch.randn(NGRID, NBLOCK, generator=dgen, dtype=torch.float64,
                      device=dev)
    a = blk.mT
    launched = split_gemm.launches
    got = split_gemm.matmul(a, psi, "split3")
    if split_gemm.launches != launched + SPLIT3_LAUNCHES:
        raise AssertionError(f"split3 dgemm: {split_gemm.launches - launched}"
                             f" launches, want {SPLIT3_LAUNCHES}")
    native = ref.matmul(a, psi)
    scale = ref.matmul(a.abs(), psi.abs()).abs().max().item()
    split_err = (got - native).abs().max().item()
    bound_rel = precision.error_bound("split3", NGRID)
    if not split_err / scale <= bound_rel:
        raise AssertionError(f"split3 dgemm: error {split_err / scale:.3e}"
                             f" of max|A||B| > bound {bound_rel:.3e}")
    plain_err = (got - precision.matmul(a, psi, "split3")).abs().max().item()
    if not plain_err / scale <= bound_rel:
        raise AssertionError(f"split3 dgemm: kernel passes vs plain passes "
                             f"{plain_err / scale:.3e} of max|A||B| > "
                             f"{bound_rel:.3e}")
    log("kernels", f"split3 dgemm {NBLOCK}x{NSTATES}x{NGRID}: max|split - "
                   f"native| / max(|A||B|) = {split_err / scale:.3e}, "
                   f"max|split - plain passes| / max(|A||B|) = "
                   f"{plain_err / scale:.3e} (a-priori bound "
                   f"{bound_rel:.3e})")
    del got, native
    # the kernel's slices, bit for bit those of precision.slices
    for x, name in ((psi[:4096], "Psi rows"), (blk, "Hpsi_blk")):
        for scheme in ("split2", "split3"):
            for i, (kern, want) in enumerate(zip(
                    split_gemm.slices(x, scheme),
                    precision.slices(x, scheme))):
                if not torch.equal(kern, want):
                    raise AssertionError(f"{scheme} slice {i} of {name}: "
                                         f"kernel != precision.slices")
    log("kernels", "split_gemm.cu slices of Psi and Hpsi_blk equal "
                   "precision.slices bit for bit (split2 and split3, the "
                   "bf16 tail included)")
    for k in (256, NGRID):
        exact_pass_check(dgen, NBLOCK, k, NSTATES, dev)
    split_row = dict(name="split_gemm", route="cuda",
                     source="src/repro_torch/csrc/split_gemm.cu",
                     replaces="src/repro/kernels/split_gemm.py:31",
                     max_abs_err=split_err, **split_times(a, psi))
    return {"syrk": syrk_row, "split_gemm": split_row}


def exact_pass_operands(gen, m: int, k: int, n: int, dev):
    """fp64 A (m x k) and B (k x n) whose split3 slices and slice
    products are exact, with their exact product.  Each element is
    s (h + l + t), h in {1, 1.5}, l in {1, 1.5} 2^-25, t in {1, 1.5} 2^-51:
    the slices are s h, s l and the bf16 tail s t exactly, and every
    float32 slice product over a 256-column chunk is exact.  A's second
    half of columns repeats the first half's hi part, and B's second half
    of rows negates it in the first half of B's columns: there hi*hi
    cancels to 0, so every pass, lo and tail included, shows in the
    result.  tests/test_torch_precision.py builds the same operands."""
    import torch

    def parts(rows, cols):
        def pick(scale):
            return (1.0 + 0.5 * torch.randint(
                0, 2, (rows, cols), generator=gen, device=dev,
                dtype=torch.float64)) * scale
        sign = 2.0 * torch.randint(0, 2, (rows, cols), generator=gen,
                                   device=dev, dtype=torch.float64) - 1.0
        return sign, pick(1.0), pick(2.0 ** -25), pick(2.0 ** -51)

    sa, ha, la, ta = parts(m, k)
    sb, hb, lb, tb = parts(k, n)
    h, c = k // 2, n // 2
    sa[:, h:2 * h], ha[:, h:2 * h] = sa[:, :h], ha[:, :h]
    sb[h:2 * h, :c], hb[h:2 * h, :c] = -sb[:h, :c], hb[:h, :c]
    pa = [sa * x for x in (ha, la, ta)]
    pb = [sb * x for x in (hb, lb, tb)]
    del sa, ha, la, ta, sb, hb, lb, tb
    exact = torch.zeros(m, n, dtype=torch.float64, device=dev)
    for i, j in sorted(((i, j) for i in range(3) for j in range(3)),
                       key=lambda p: -sum(p)):
        exact += pa[i] @ pb[j]                  # each product exact in fp64
    return pa[0] + pa[1] + pa[2], pb[0] + pb[1] + pb[2], exact


def exact_pass_check(gen, m: int, k: int, n: int, dev) -> None:
    """split3 in the fused kernel and on the plain passes against the
    exact product of exact-pass operands, column by column.  A pass left
    out or a wrong slice reads 1.5e-8 or more there; both venues read
    ~1e-15 on the CPU.  Negative controls: the kernel with each one pass
    left out of its sum must read over the limit."""
    import torch
    from repro_torch.core import precision
    from repro_torch.kernels import split_gemm
    a, b, exact = exact_pass_operands(gen, m, k, n, dev)
    denom = exact.abs().amax(dim=0)

    def colrel(got):
        return ((got - exact).abs().amax(dim=0) / denom).max().item()
    kern = split_gemm.matmul(a, b, "split3")
    plain = precision.matmul(a, b, "split3")
    readings = {"kernel passes": colrel(kern), "plain passes": colrel(plain),
                "native dgemm": colrel(a @ b)}
    same = bool(torch.equal(kern, plain))
    dropped = {p: colrel(split_gemm.fused(a, b, "split3", drop=(p,)))
               for p in precision._PASSES["split3"]}
    del a, b, kern, plain, exact
    if not (readings["kernel passes"] <= EXACT_PASS_TOL
            and readings["plain passes"] <= EXACT_PASS_TOL):
        raise AssertionError(f"split3 exact-pass {m}x{n}x{k}: {readings} "
                             f"> {EXACT_PASS_TOL:g}")
    for p, v in dropped.items():
        if not v > EXACT_PASS_TOL:
            raise AssertionError(f"control split3 without pass {p} at "
                                 f"{m}x{n}x{k}: {v:.3e} <= "
                                 f"{EXACT_PASS_TOL:g}; the check cannot "
                                 f"see a dropped pass")
    log("kernels", f"split3 exact-pass {m}x{n}x{k}: column-relative error "
                   f"vs the exact product "
                   + ", ".join(f"{name} {v:.3e}"
                               for name, v in readings.items())
                   + f" (limit {EXACT_PASS_TOL:g} on the split3 pair; "
                   f"kernel == plain bit for bit: {same}); controls, the "
                   f"kernel without one pass: "
                   + ", ".join(f"{p} {v:.3e}" for p, v in dropped.items())
                   + f" (each must exceed {EXACT_PASS_TOL:g})")


def causal_pairs(t: int, window: int) -> int:
    """Live (query, key) pairs of causal attention over t positions, with
    keys at most ``window - 1`` behind (0: no window)."""
    if window <= 0 or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def sdpa(q, k, v, **kw):
    """torch's scaled_dot_product_attention with GQA: the library
    yardstick (library_ms), never called by the port."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def flash_bound(logits: int, d: int, nbytes: float, softcap: bool) -> tuple:
    """The least time of a flash call: the larger of its tensor-core
    operations (4 d per live logit) at the bf16 peak, its special-function
    operations (ex2 and rcp of the soft-cap's tanh and ex2 of the softmax:
    3 per live logit, 1 without the cap) at PEAK_MUFU, and its bytes (q, k,
    v read once, the output written once).  Returns (ms, bound_by, which
    term binds)."""
    terms = {
        "tensor-core operations": 4.0 * d * logits / PEAK_OPS["bfloat16"],
        "MUFU operations": (3 if softcap else 1) * logits / PEAK_MUFU,
        "bytes": nbytes / PEAK_BYTES}
    term = max(terms, key=terms.get)
    detail = ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in terms.items())
    return (terms[term] * 1e3, "bytes" if term == "bytes" else "operations",
            f"{term}; {detail}")


def flash_head_sizes(dev, gen) -> None:
    """The wgmma path at qwen1.5-4b's head size (128) and at 64, in bf16
    and f16: per-row checks where softcap 50 bites, path asserted."""
    import torch
    from repro_torch.kernels import attention
    for d in (128, 64):
        for dt in (torch.bfloat16, torch.float16):
            q, k, v = (torch.randn(*shape, generator=gen, device=dev,
                                   dtype=dt)
                       for shape in ((2, 8, 2048, d), (2, 4, 2048, d),
                                     (2, 4, 2048, d)))
            q = q * ATTN_Q_SCALE
            kw = dict(causal=True, softcap=50.0)
            before = attention.launches_by_path[attention.WGMMA]
            got = attention.flash_attention(q, k, v, **kw)
            if attention.launches_by_path[attention.WGMMA] != before + 1:
                raise AssertionError(f"flash_attention D={d} {dt}: not on "
                                     f"the wgmma path")
            check_rows(f"flash_attention {str(dt)[6:]} [2,8,2048,{d}] "
                       f"softcap 50 (wgmma path)", got,
                       attention.flash_attention_plain(q, k, v, **kw),
                       ATTN_TOL)


def flash_fma_checks(dev, gen) -> None:
    """The FMA path, which the plan keeps for float32 and D 16/32: float32
    at the serve shape (window 4096) and bf16 at D 32, each per row against
    the plain version where softcap 50 bites, path asserted, beside a
    control without the softcap that must fail the same check.  float32's
    tolerance is TOL's: both sides compute in float32 and differ in
    summation order and in tanhf/expf against torch's, ~1e-6 of a row."""
    import torch
    from repro_torch.kernels import attention
    cases = (("float32", torch.float32, (2, 16, SERVE_PROMPT, 256),
              (2, 8, SERVE_PROMPT, 256), 4096, TOL["float32"]),
             ("bf16", torch.bfloat16, (2, 8, 2048, 32), (2, 4, 2048, 32), 0,
              ATTN_TOL))
    for label, dt, q_shape, kv_shape, window, tol in cases:
        q, k, v = (torch.randn(*shape, generator=gen, device=dev, dtype=dt)
                   for shape in (q_shape, kv_shape, kv_shape))
        q = q * ATTN_Q_SCALE
        kw = dict(causal=True, softcap=50.0, window=window)
        name = (f"flash_attention {label} {list(q_shape)} window {window} "
                f"softcap 50 (FMA path)")
        before = attention.launches_by_path[attention.FMA]
        got = attention.flash_attention(q, k, v, **kw)
        if attention.launches_by_path[attention.FMA] != before + 1:
            raise AssertionError(f"{name}: not on the FMA path")
        want = attention.flash_attention_plain(q, k, v, **kw)
        check_rows(name, got, want, tol)
        control(f"{name} without softcap vs plain with softcap 50",
                attention.flash_attention(q, k, v, causal=True,
                                          window=window), want, tol)
        if dt == torch.float32:
            ms = time_ms(lambda: attention.flash_attention(q, k, v, **kw),
                         reps=3)
            log("kernels", f"{name}: kernel {ms:.3f} ms")


def phase_kernels_attention(dev) -> dict:
    """Flash and decode attention against their plain versions at
    gemma2-9b's serve shapes, in bf16, with q scaled so that the softcap
    bites (ATTN_Q_SCALE); then negative controls, each of which must fail
    the same check: the kernel at another window, without the softcap,
    or past kv_len, against the plain version of the real call."""
    import torch
    from repro_torch.kernels import attention, decode_attention
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    b, hq, hkv, t, d = SERVE_BATCH, 16, 8, SERVE_PROMPT, 256
    q, k, v = rnd(b, hq, t, d) * ATTN_Q_SCALE, rnd(b, hkv, t, d), \
        rnd(b, hkv, t, d)
    std = (q[0, 0].float() @ k[0, 0].float().T / math.sqrt(d)).std().item()
    log("kernels", f"attention inputs: randn q x {ATTN_Q_SCALE:g}, k, v; "
                   f"logits q.k / 16 with std {std:.1f} before softcap 50")
    nbytes = 2 * (2 * b * hq * t * d + 2 * b * hkv * t * d)
    if attention.plan(q, k, v) != attention.Plan(attention.WGMMA,
                                                 (False,) * 3):
        raise AssertionError(f"flash_attention at the serve shape: plan "
                             f"{attention.plan(q, k, v)}, want the wgmma "
                             f"path without copies")
    flash_row, outs = None, {}
    for window in (0, 4096):
        kw = dict(causal=True, softcap=50.0, window=window)
        before = attention.launches_by_path[attention.WGMMA]
        got = attention.flash_attention(q, k, v, **kw)
        if attention.launches_by_path[attention.WGMMA] != before + 1:
            raise AssertionError("flash_attention: the serve shape did not "
                                 "launch the wgmma path")
        want = attention.flash_attention_plain(q, k, v, **kw)
        err = check_rows(f"flash_attention bf16 [{b},{hq},{t},{d}] window "
                         f"{window} softcap 50 (wgmma path)", got, want,
                         ATTN_TOL)
        outs[window] = (got, want)
        ms = time_ms(lambda: attention.flash_attention(q, k, v, **kw), reps=5)
        differ = sum(not torch.equal(attention.flash_attention(q, k, v, **kw),
                                     got) for _ in range(FLASH_REPEATS))
        if differ:
            raise AssertionError(f"flash_attention window {window}: {differ} "
                                 f"of {FLASH_REPEATS} repeats differ from "
                                 f"the first call")
        log("kernels", f"flash_attention window {window}: {FLASH_REPEATS} "
                       f"repeats equal to the first call bit for bit")
        plain_ms = time_ms(
            lambda: attention.flash_attention_plain(q, k, v, **kw), reps=2)
        lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True), reps=5)
        pairs = causal_pairs(t, window)
        bms, by, term = flash_bound(b * hq * pairs, d, nbytes, softcap=True)
        log("kernels", f"flash_attention window {window}: kernel {ms:.3f} ms "
                       f"({4.0 * b * hq * d * pairs / ms / 1e9:.1f} TFLOP/s "
                       f"on {pairs} live pairs), plain {plain_ms:.3f} ms, "
                       f"sdpa (causal, no softcap or window) {lib_ms:.3f} "
                       f"ms, bound {bms:.4f} ms ({term})")
        if window == 0:
            flash_row = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/attention.py:28",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
    control("flash_attention window 0 vs plain window 4096", outs[0][0],
            outs[4096][1], ATTN_TOL)
    control("flash_attention without softcap vs plain with softcap 50",
            attention.flash_attention(q, k, v, causal=True), outs[0][1],
            ATTN_TOL)
    del q, k, v, outs
    flash_head_sizes(dev, gen)
    flash_fma_checks(dev, gen)
    s_len, kv_len = SERVE_LEN, SERVE_PROMPT + 1
    q, k, v = rnd(b, hq, 1, d) * ATTN_Q_SCALE, rnd(b, hkv, s_len, d), \
        rnd(b, hkv, s_len, d)
    # the dead slots past kv_len hold keys 4x larger, whose capped logits
    # (~+-50) would outweigh the live ones if any were read
    k[:, :, kv_len:] *= 4
    kw = dict(softcap=50.0)
    want = decode_attention.decode_attention_plain(q, k, v, kv_len, **kw)
    err = check_rows(f"decode_attention bf16 q [{b},{hq},1,{d}] cache "
                     f"[{b},{hkv},{s_len},{d}] kv_len {kv_len} softcap 50",
                     decode_attention.decode_attention(q, k, v, kv_len, **kw),
                     want, ATTN_TOL)
    control(f"decode_attention at kv_len {s_len} vs plain at {kv_len}",
            decode_attention.decode_attention(q, k, v, s_len, **kw), want,
            ATTN_TOL)
    control("decode_attention without softcap vs plain with softcap 50",
            decode_attention.decode_attention(q, k, v, kv_len), want,
            ATTN_TOL)
    # kv_len read on the device: the grid covers every chunk of the cache,
    # the same arithmetic on the same chunks, so the same bits
    got = decode_attention.decode_attention(q, k, v, kv_len, **kw)
    dev_len = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    before = (decode_attention.launches, decode_attention.memsets,
              decode_attention.copies)
    on_dev = decode_attention.decode_attention(q, k, v, dev_len, **kw)
    after = (decode_attention.launches, decode_attention.memsets,
             decode_attention.copies)
    if tuple(a - b for a, b in zip(after, before)) != (1, 1, 0):
        raise AssertionError(f"decode_attention: (launches, ticket "
                             f"memsets, cache copies) of one call "
                             f"{tuple(a - b for a, b in zip(after, before))}"
                             f", want (1, 1, 0)")
    if not torch.equal(on_dev, got):
        raise AssertionError("decode_attention: device kv_len != host int")
    differ = sum(not torch.equal(decode_attention.decode_attention(
        q, k, v, dev_len if i % 2 else kv_len, **kw), got)
        for i in range(FLASH_REPEATS))
    if differ:
        raise AssertionError(f"decode_attention: {differ} of "
                             f"{FLASH_REPEATS} repeats differ from the "
                             f"first call")
    log("kernels", f"decode_attention: device kv_len equals the host int "
                   f"bit for bit; {FLASH_REPEATS} repeats (host and device "
                   f"kv_len in turn) equal to the first call")
    # ms, as every row: CUDA events around back-to-back calls, which for a
    # call of tens of microseconds the wrapper's host time can set; beside
    # it the device time per call from the profiler, over every device
    # event of the call (the kernel, the tickets' memset, a copy if any)
    live = (torch.arange(s_len, device=dev) < kv_len)[None, None, None]
    calls = {
        "kernel": lambda: decode_attention.decode_attention(q, k, v, kv_len,
                                                            **kw),
        "kernel, kv_len on the device": lambda: decode_attention.
        decode_attention(q, k, v, dev_len, **kw),
        "plain": lambda: decode_attention.decode_attention_plain(
            q, k, v, kv_len, **kw),
        "sdpa (kv_len mask, no softcap)": lambda: sdpa(q, k, v,
                                                       attn_mask=live)}
    per = {name: (device_ms(fn, 50), time_ms(fn, reps=50 if name !=
                                               "plain" else 10))
           for name, fn in calls.items()}
    ms, plain_ms = per["kernel"][1], per["plain"][1]
    lib_ms = per["sdpa (kv_len mask, no softcap)"][1]
    nbytes = 2 * (2 * b * hkv * kv_len * d + 2 * b * hq * d)
    bms, by = bound(4.0 * b * hq * d * kv_len, nbytes, "bfloat16")
    p = decode_attention.plan(b, hkv, s_len, d, kv_len)
    log("kernels", f"decode_attention: one launch of {p.grid} chunks of "
                   f"{p.chunk} keys x {b * hkv} pairs = {p.blocks} blocks "
                   f"on 132 SMs ({decode_attention.plan(b, hkv, s_len, d).blocks}"
                   f" with kv_len on the device); device ms per call "
                   f"(profiler), and ms per call back to back (CUDA "
                   f"events, the JSON's): "
                   + "; ".join(f"{name} {dms:.4f} / {ems:.4f}"
                               for name, (dms, ems) in per.items())
                   + f"; kernel {nbytes / per['kernel'][0] / 1e6:.1f} GB/s "
                   f"of the bound's bytes in device time, bound {bms:.4f} "
                   f"ms ({by})")
    decode_row = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:29",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)
    return {"flash_attention": flash_row, "decode_attention": decode_row}


KERNELS = ("gemm", "trsm", "syrk", "split_gemm", "flash_attention",
           "decode_attention")
MODULES = {"gemm": "gemm", "trsm": "trsm", "syrk": "syrk",
           "split_gemm": "split_gemm", "flash_attention": "attention",
           "decode_attention": "decode_attention"}


def reset_counts() -> None:
    import importlib
    for mod in MODULES.values():
        importlib.import_module(f"repro_torch.kernels.{mod}").reset_launches()


def counts() -> dict:
    import importlib
    return {name: importlib.import_module(
        f"repro_torch.kernels.{mod}").launches
        for name, mod in MODULES.items()}


def no_faults(stats, where: str) -> None:
    """A phase that injects nothing must see no fault path run: a fault
    absorbed quietly would hide a broken kernel behind a host fallback."""
    got = (stats.faults, stats.retries, stats.fallbacks, stats.quarantines)
    if got != (0, 0, 0, 0):
        raise AssertionError(f"{where}: (faults, retries, fallbacks, "
                             f"quarantines) {got} != (0, 0, 0, 0)")


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
    no_faults(s.stats, "blas")
    st = s.stats.per_routine
    sg, dt = st["sgemm"], st["dtrsm"]
    want = (sg.calls, sg.offloaded, sg.on_host, sg.bytes_in,
            sg.cache_hits, dt.calls, dt.offloaded, dt.bytes_in)
    expect = (3, 2, 1, 3 * n * n * 4, 3, 1, 1, (6912 * 6912 + 6912 * 32) * 8)
    if want != expect:
        raise AssertionError(f"blas counters {want} != {expect}")
    if sg.transient_bytes != 2 * 64 * 64 * 4:
        raise AssertionError(f"small mm streamed {sg.transient_bytes} B")
    if launched["gemm"] < 3 or launched["trsm"] != 1:
        raise AssertionError(f"blas launches {launched}: want 3 or more "
                             f"gemm and 1 trsm (one launch per solve)")
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


def phase_lsms(s, dev, n: int = 6912) -> tuple:
    import numpy as np
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
    blas_before = sum(r.seconds for r in s.stats.per_routine.values())
    reset_counts()
    t0 = time.perf_counter()
    out = lsms.run_mini(atoms=atoms, energies=energies, scf=1, n=n,
                        dtype=torch.complex128, device=dev)
    s.sync()
    wall = time.perf_counter() - t0
    blas_s = sum(r.seconds for r in s.stats.per_routine.values()) \
        - blas_before
    # the loop's numpy draws alone (run_mini's order: G per atom, then a
    # t-matrix per solve), timed apart: host work inside the wall
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    for _ in range(2 * atoms + atoms * energies):
        rng.standard_normal((n, n))
    draws_s = time.perf_counter() - t0
    launched = counts()
    no_faults(s.stats, "lsms")
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
    log("lsms", f"loop wall {wall:.3f} s: intercepted BLAS calls "
                f"{blas_s:.3f} s, the rest (host draws and arithmetic, "
                f"copies, LU and checks) {wall - blas_s:.3f} s; the numpy "
                f"draws alone {draws_s:.3f} s")
    for line in s.report().splitlines():
        log("lsms", line)
    return launched, out["energy"]


class SolverClock:
    """Times the solver tier on the card for the ``with`` block: each
    driver call of ``repro_torch.solvers.drivers`` (one span each) and
    the unblocked panels (``repro_torch.core.lapack._pivot_panel``)
    inside it, each synchronized before and after, with the bytes the
    session moved during the span.  ``first`` keeps each driver's first
    arguments, for the library yardstick on the same inputs."""

    DRIVERS = ("getrf", "getrs", "gesv", "potrf", "potrs", "syev")

    def __init__(self, stats):
        self.stats = stats
        self.spans = []          # (span id, wall s, panels s, moved B)
        self.first = {}
        self._panel_s = 0.0
        self._saved = []

    def __enter__(self):
        import torch
        from repro_torch.core import lapack
        from repro_torch.solvers import drivers
        panel = lapack._pivot_panel

        def timed_panel(p):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = panel(p)       # ends with the pivots' copy to the host
            self._panel_s += time.perf_counter() - t0
            return out
        self._saved = [(lapack, "_pivot_panel", panel)]
        lapack._pivot_panel = timed_panel
        for name in self.DRIVERS:
            fn = getattr(drivers, name)
            self._saved.append((drivers, name, fn))
            setattr(drivers, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        import torch

        def timed(*args, **kw):
            self.first.setdefault(name, args)
            torch.cuda.synchronize()
            moved0 = self.stats.total_moved_bytes
            self._panel_s = 0.0
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.spans.append((f"{name}#{len(self.spans)}",
                               time.perf_counter() - t0, self._panel_s,
                               self.stats.total_moved_bytes - moved0))
            return out
        return timed

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def split(self, trace, sid: str) -> tuple:
        """(wall, panels, gemm, trsm, calls of each) of one span: the
        intercepted calls' synchronized seconds off the trace."""
        from repro_torch.core import threshold as thr
        wall, panel_s = next((w, p) for i, w, p, _ in self.spans
                             if i == sid)
        secs = {"gemm": 0.0, "trsm": 0.0}
        n = {"gemm": 0, "trsm": 0}
        for c in trace.calls:
            base = thr.base_routine(c.routine)
            if c.solver_id == sid and base in secs:
                secs[base] += c.seconds
                n[base] += 1
        return wall, panel_s, secs["gemm"], secs["trsm"], n["gemm"], n["trsm"]


def backward_error(a, x, b) -> float:
    """|A x - b|_inf / (|A|_inf |x|_inf), matrix infinity norms, with the
    plain (uncounted) product."""
    import torch
    from repro_torch.kernels import ref
    r = ref.torch_matmul(a, x) - b
    inf = float("inf")
    return (torch.linalg.matrix_norm(r, ord=inf)
            / (torch.linalg.matrix_norm(a, ord=inf)
               * torch.linalg.matrix_norm(x, ord=inf))).item()


def wall_s(fn, reps: int = 1) -> float:
    """Mean synchronized wall seconds of ``fn`` over ``reps`` calls after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def phase_solvers(dev, lsms_energy: float, n: int = 6912) -> dict:
    """The LAPACK solver tier on the card, in one DFU session with
    ``lapack`` on (lapack_nb 256, synchronized so that each intercepted
    call's seconds are device-inclusive) and a trace: (a) LSMS's KKR loop
    at n 6912 through torch.linalg.lu_factor/lu_solve, now the patched
    tier; (b) the real tier at production widths: torch.linalg.solve and
    cholesky + cholesky_solve at n 6912, eigh at n 2400; (c) the dumped
    trace replayed by the port's memtier simulator to the live
    per-solver counters, and the autotuner's recommendation for it."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import OffloadConfig
    from repro_torch.apps import lsms
    from repro_torch.core.trace import Trace
    from repro_torch.kernels import ref
    from repro_torch.memtier import MemTierSimulator
    from repro_torch.memtier.spec import SPECS
    from repro_torch.tools import autotune
    atoms, energies = 2, 2
    panels = -(-n // SOLVER_NB)
    f64 = torch.float64
    cfg = OffloadConfig(policy="dfu", threshold=500.0, lapack=True,
                        lapack_nb=SOLVER_NB, sync=True)
    path = ROOT / "build" / "solvers_trace.json"
    path.parent.mkdir(exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=f64, device=dev)
    reset_counts()
    with repro_torch.session(cfg, device=dev) as s, \
            SolverClock(s.stats) as clock:
        # (a) LSMS through the tier
        t0 = time.perf_counter()
        out = lsms.run_mini(atoms=atoms, energies=energies, scf=1, n=n,
                            dtype=torch.complex128, device=dev)
        s.sync()
        wall = time.perf_counter() - t0
        launched_a = counts()
        st = s.stats
        no_faults(st, "solvers (a)")
        want = atoms * energies          # solves: one getrf, one getrs
        got = (st.solvers["getrf"].spans, st.solvers["getrs"].spans,
               s.trace.event_count("solver_begin"),
               s.trace.event_count("solver_end"),
               st.solvers["getrf"].panel_calls)
        expect = (want, want, 2 * want, 2 * want, want * panels)
        if got != expect:
            raise AssertionError(f"solvers (a): getrf/getrs spans, begin/"
                                 f"end events, panels {got} != {expect}")
        if not out["max_resid"] < LSMS_RESID:
            raise AssertionError(f"solvers (a): max_resid "
                                 f"{out['max_resid']:.3e}")
        if not (abs(out["energy"] - lsms_energy)
                <= LSMS_ENERGY_RTOL * abs(lsms_energy)):
            raise AssertionError(f"solvers (a): energy {out['energy']!r} "
                                 f"vs the native LU's {lsms_energy!r}")
        z = st.per_routine["zgemm"]
        if z.bytes_in != atoms * n * n * 16:
            raise AssertionError(f"solvers (a): zgemm moved {z.bytes_in} "
                                 f"B, want G once per atom")
        log("solvers", f"(a) lsms n={n} through the tier: energy "
                       f"{out['energy']:.12f} (native LU "
                       f"{lsms_energy:.12f}), max_resid "
                       f"{out['max_resid']:.3e}, {want} getrf + {want} getrs "
                       f"spans, {st.solvers['getrf'].panel_calls} panels, "
                       f"zgemm bytes_in {z.bytes_in} (G once per atom), "
                       f"loop wall {wall:.3f} s, launches {launched_a}")
        for sid, _, _, moved in clock.spans:
            if sid.startswith("getrf"):
                w, p, g, t, ng, nt = clock.split(s.trace, sid)
                log("solvers", f"(a) {sid}: {w:.3f} s = panels {p:.3f} + "
                               f"zgemm {g:.3f} ({ng} calls) + ztrsm {t:.3f} "
                               f"({nt}) + the rest {w - p - g - t:.3f} "
                               f"(row swaps, copies); moved {moved} B")
            else:
                w, _, g, t, ng, nt = clock.split(s.trace, sid)
                log("solvers", f"(a) {sid}: {w:.3f} s, ztrsm {t:.3f} "
                               f"({nt} calls); moved {moved} B")
        m_first, = clock.first["getrf"]
        tm_first = clock.first["getrs"][2]
        n_a = len(clock.spans)
        # (b) the real tier at production widths
        b = rnd(n, 32)
        a = rnd(n, n)
        x = torch.linalg.solve(a, b)
        berr_solve = backward_error(a, x, b)
        g = rnd(n, n)
        h = ref.torch_matmul(g, g.mT) / n + torch.eye(n, dtype=f64,
                                                      device=dev)
        del g
        lf = torch.linalg.cholesky(h)
        y = torch.cholesky_solve(b, lf)
        berr_chol = backward_error(h, y, b)
        upper = lf.triu(1).abs().max().item()
        ne = NSTATES
        e0 = rnd(ne, ne)
        e = (e0 + e0.mT) / 2
        del e0
        w, vecs = torch.linalg.eigh(e)
        launched = counts()
        no_faults(s.stats, "solvers (b)")
        live = {name: (sv.spans, sv.calls, sv.panel_calls)
                for name, sv in st.solvers.items()}
        for line in s.report().splitlines():
            log("solvers", line)
        s.trace.dump(str(path))
    lim = SOLVE_BERR_FACTOR * n * EPS64
    for label, berr in (("solve", berr_solve), ("cholesky_solve",
                                                 berr_chol)):
        if not berr <= lim:
            raise AssertionError(f"solvers (b): {label} backward error "
                                 f"{berr:.3e} > {lim:.3e}")
    if upper != 0.0:
        raise AssertionError(f"solvers (b): cholesky factor has {upper} "
                             f"above its diagonal")
    def n1(mat):
        return torch.linalg.matrix_norm(mat, ord=1).item()
    norm_e = n1(e)
    resid = n1(ref.torch_matmul(e, vecs) - vecs * w) / norm_e
    orth = n1(ref.torch_matmul(vecs.mT, vecs)
              - torch.eye(ne, dtype=f64, device=dev))
    w_native = torch.linalg.eigvalsh(e)
    werr = (w - w_native).abs().max().item() / norm_e
    if not (resid <= EIGH_TOL and orth <= EIGH_TOL and werr <= EIGH_TOL):
        raise AssertionError(f"solvers (b): eigh |AS - Sw|_1/|A|_1 "
                             f"{resid:.3e}, |S^T S - I|_1 {orth:.3e}, "
                             f"|w - eigvalsh| / |A|_1 {werr:.3e} (limit "
                             f"{EIGH_TOL:g})")
    tier = {sid.split("#")[0]: (wl, p) for sid, wl, p, _ in
            clock.spans[n_a:]}
    log("solvers", f"(b) solve f64 {n}x32: backward error {berr_solve:.3e} "
                   f"(limit {lim:.3e}); cholesky + cholesky_solve f64 {n}: "
                   f"{berr_chol:.3e}, nothing above the factor's diagonal; "
                   f"eigh f64 {ne}: |AS - Sw|_1/|A|_1 {resid:.3e}, "
                   f"|S^T S - I|_1 {orth:.3e}, |w - eigvalsh|/|A|_1 "
                   f"{werr:.3e} (limit {EIGH_TOL:g}); phase launches "
                   f"{launched}")
    # the library yardstick on the same inputs, outside the session
    lu_native = wall_s(lambda: torch.linalg.lu_solve(
        *torch.linalg.lu_factor(m_first), tm_first))
    getrf_w = [wl for sid, wl, _, _ in clock.spans if sid.startswith("getrf")]
    getrs_w = [wl for sid, wl, _, _ in clock.spans if sid.startswith("getrs")]
    log("solvers", f"(a) LU of M ({n}, complex128): the tier's getrf "
                   f"{np.mean(getrf_w):.3f} s + getrs {np.mean(getrs_w):.3f} "
                   f"s per solve (mean of {len(getrf_w)}); cuSOLVER "
                   f"lu_factor + lu_solve {lu_native:.3f} s")
    natives = {
        "gesv": wall_s(lambda: torch.linalg.solve(a, b)),
        "potrf": wall_s(lambda: torch.linalg.cholesky(h)),
        "potrs": wall_s(lambda: torch.cholesky_solve(b, lf)),
        "syev": wall_s(lambda: torch.linalg.eigh(e)),
    }
    for name, nat in natives.items():
        wl, p = tier[name]
        log("solvers", f"(b) {name}: the tier {wl:.3f} s (panels {p:.3f} "
                       f"s), the library {nat:.3f} s")
    del a, b, x, h, lf, y, e, vecs, m_first, tm_first
    # (c) live equals replay, off the dumped trace
    trace = Trace.load(str(path))
    rep = MemTierSimulator(SPECS["gh200"], policy="dfu",
                           threshold=500.0).run(trace)
    replay = {name: (d["spans"], d["calls"], d["panel_calls"])
              for name, d in rep.per_solver.items()}
    if replay != live:
        raise AssertionError(f"solvers (c): replay {replay} != live {live}")
    t0 = time.perf_counter()
    tuned = autotune.autotune(trace, policies=("dfu", "memcopy"),
                              device_counts=(1,), device_bytes=None)
    log("solvers", f"(c) replay of {len(trace)} calls equals the live "
                   f"per-solver counters {live}; autotune "
                   f"({len(tuned.points)} points, "
                   f"{time.perf_counter() - t0:.1f} s):")
    for line in autotune.format_recommendation(tuned).splitlines():
        log("solvers", f"(c)   {line}")
    torch.cuda.empty_cache()
    if launched["gemm"] == 0 or launched["trsm"] == 0:
        raise AssertionError(f"solvers: launches {launched}: gemm.cu and "
                             f"trsm.cu must both launch")
    return launched


def gram_site(psi):
    """One stable call site for the adaptive race of phase (a)."""
    from repro_torch.core import blas
    return blas.syrk(psi, trans="T")


def phase_venue(dev) -> dict:
    """The kernel venue, adaptive racing and split precision at PARSEC's
    production shapes, each in its own DFU session, inputs host-first."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import OffloadConfig
    from repro_torch.core import blas, host_array
    from repro_torch.core import precision
    from repro_torch.kernels import ref, syrk
    rng = np.random.default_rng(2)
    t0 = time.perf_counter()
    psi = host_array(rng.standard_normal((NGRID, NSTATES)), torch.float64)
    blks = [host_array(rng.standard_normal((NGRID, NBLOCK)), torch.float64)
            for _ in range(3)]
    log("venue", f"inputs made on the host in "
                 f"{time.perf_counter() - t0:.1f} s (Psi {psi.nbytes / 1e9:.2f}"
                 f" GB, pinned)")
    psi_dev = psi.to(dev)
    want_gram = syrk.syrk_plain(psi_dev, trans="T")
    launched = {}

    # (a) 8 calls at one site race host / xla / pallas, then lock
    cfg = OffloadConfig(policy="dfu", kernel_path=True, adaptive=True)
    reset_counts()
    with repro_torch.session(cfg) as s:
        grams = [gram_site(psi) for _ in range(8)]
        s.sync()
        got = counts()
        (prof,) = list(s.runtime.callsites)
        venues = [c.venue for c in s.trace.calls]
        per_call = [c.seconds for c in s.trace.calls]
        st = s.stats.per_routine["dsyrk"]
        no_faults(s.stats, "venue (a)")
    for name in got:
        launched[name] = launched.get(name, 0) + got[name]
    for i, g in enumerate(grams):
        _, rel = rel_err(g, want_gram)
        if not rel <= TOL["float64"]:
            raise AssertionError(f"venue (a) call {i}: rel err {rel:.3e}")
    if prof.locked is None or venues[:6] != ["host", "xla", "pallas"] * 2:
        raise AssertionError(f"venue (a): site not locked after the "
                             f"warmup, venues {venues}")
    if prof.kernel_timed != 2 or got["syrk"] < 2:
        raise AssertionError(f"venue (a): {prof.kernel_timed} pallas "
                             f"probes, {got['syrk']} syrk launches")
    log("venue", f"(a) dsyrk n={NSTATES} k={NGRID} x8 at one site: venues "
                 f"{venues}; locked {prof.locked_venue} ({prof.locked_why});"
                 f" best host {prof.host_best * 1e3:.3f} ms, xla "
                 f"{prof.device_best * 1e3:.3f} ms, pallas "
                 f"{prof.kernel_best * 1e3:.3f} ms; per-call s "
                 f"{[round(x, 5) for x in per_call]}; bytes_in {st.bytes_in}"
                 f", transient {st.transient_bytes}; launches {got}; "
                 f"results within {TOL['float64']:g} of the plain version")
    del grams, want_gram

    # (b) split precision picked by auto, on the pallas venue
    cfg = OffloadConfig(policy="dfu", kernel_path=True, precision="auto")
    if precision.choose("auto", "gemm", NGRID, cfg.precision_rtol) != \
            "split3":
        raise AssertionError("auto does not pick split3 at K = NGRID")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with repro_torch.session(cfg) as s:
        outs = [torch.matmul(b.mT, psi) for b in blks]   # intercepted
        s.sync()
        got = counts()
        calls = [(c.precision, c.venue) for c in s.trace.calls]
        st = s.stats.per_routine["dgemm"]
        no_faults(s.stats, "venue (b)")
        secs = [c.seconds for c in s.trace.calls]
    peak = torch.cuda.max_memory_allocated()
    for name in got:
        launched[name] += got[name]
    n = len(blks)
    if (calls != [("split3", "pallas")] * n or st.split_calls != n
            or st.kernel_calls != n or st.escalations != 0):
        raise AssertionError(f"venue (b): calls {calls}, split "
                             f"{st.split_calls}, kernel {st.kernel_calls}, "
                             f"escalations {st.escalations}")
    if got["split_gemm"] != n * SPLIT3_LAUNCHES or got["gemm"] != 0:
        raise AssertionError(f"venue (b): launches {got}, want "
                             f"{SPLIT3_LAUNCHES} of split_gemm.cu per call "
                             f"and none of gemm.cu")
    bound_rel = precision.error_bound("split3", NGRID)
    worst = 0.0
    for b, out in zip(blks, outs):
        a = b.to(dev).mT
        native = ref.matmul(a, psi_dev)
        scale = ref.matmul(a.abs(), psi_dev.abs()).abs().max().item()
        worst = max(worst, (out - native).abs().max().item() / scale)
    if not worst <= bound_rel:
        raise AssertionError(f"venue (b): error {worst:.3e} of max|A||B| "
                             f"> bound {bound_rel:.3e}")
    log("venue", f"(b) torch.matmul(hpsi_blk.T, psi) x{n}: {calls[0]}, "
                 f"{SPLIT3_LAUNCHES} split_gemm.cu launches per call "
                 f"({got}), "
                 f"0 escalations, max|split - native| / max(|A||B|) "
                 f"{worst:.3e} (bound {bound_rel:.3e}), per-call s "
                 f"{[round(x, 4) for x in secs]} (synchronized by the "
                 f"residual check), peak device memory {peak / 1e9:.2f} GB")
    del outs, psi_dev

    # (c) a cancelling dgemm escalates to native fp64
    u = rng.standard_normal((48, 24))
    w = rng.standard_normal((24, 48))
    ca = np.concatenate([u, u], axis=1)
    cb = np.concatenate([w, -w], axis=0)
    cfg = OffloadConfig(policy="dfu", threshold=1.0, kernel_path=True,
                        precision="auto")
    reset_counts()
    with repro_torch.session(cfg) as s:
        out = blas.gemm(host_array(ca), host_array(cb))
        s.sync()
        got = counts()
        st = s.stats.per_routine["dgemm"]
        no_faults(s.stats, "venue (c)")
        esc = s.trace.event_count("escalate")
    for name in got:
        launched[name] += got[name]
    native = ref.matmul(torch.as_tensor(ca, device=dev),
                        torch.as_tensor(cb, device=dev))
    diff = (out - native).abs().max().item()
    if (st.escalations, esc) != (1, 1) or not diff <= ESCALATED_TOL:
        raise AssertionError(f"venue (c): escalations {st.escalations}, "
                             f"events {esc}, |out - native| {diff:.3e}")
    log("venue", f"(c) cancelling dgemm 48x48x48: escalated ({esc} event)"
                 f", |out - native| {diff:.3e} (tol {ESCALATED_TOL:g}); "
                 f"launches {got}")
    return launched


#: the serve phase's cross-check runs gemma2-9b's widths over one local
#: and one global layer: at the full 42 layers with random bf16 weights a
#: one-ulp change of one attention output grows into logits that differ
#: by several units, on the kernels and on the plain versions alike, so
#: no greedy token there can tell a right kernel from a wrong one
CROSS_LAYERS = 2


def generate_keeping(model, params, policy: str, n: int, prompt, dev):
    """Server.generate under ``policy``, keeping the last-position logits
    of every forward it runs (the prefill, then each decode step)."""
    import torch
    from repro_torch.train import Server, ServeConfig
    forward, kept = model.forward, []

    def keeping(params_, tokens, **kw):
        logits, aux, cache = forward(params_, tokens, **kw)
        kept.append(logits[:, -1].clone())
        return logits, aux, cache

    model.forward = keeping
    try:
        srv = Server(model, params, ServeConfig(
            max_len=SERVE_LEN, offload_policy=policy), device=dev)
        out = srv.generate(prompt, n)
    finally:
        model.forward = forward
    return srv, out, torch.stack(kept, dim=1)


def cross_check(model, params, prompt, out, cached, dev) -> dict:
    """A forward without a cache (the flash kernel on every layer) over
    the prompt and all but the last generated token, against the cached
    steps' logits (the decode kernel on global layers, plain attention on
    local ones).  Greedy tokens must agree wherever the cached top-2
    margin exceeds 2 max|dlogit|: a flip needs the leader to drop and the
    runner-up to rise, each by at most max|dlogit|."""
    import torch
    seq = torch.cat([prompt.to(dev), out[:, :-1]], dim=1)
    with torch.no_grad():
        logits, _, _ = model.forward(params, seq)
    nocache = logits[:, prompt.shape[1] - 1:]
    del logits
    if not bool(torch.isfinite(nocache).all() & torch.isfinite(cached).all()):
        raise AssertionError("serve cross-check: non-finite logits")
    delta = (nocache - cached).abs().max().item()
    top2 = cached.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * delta
    agree = nocache.argmax(-1) == out
    if not bool(agree[sure].all()):
        raise AssertionError(f"serve cross-check: tokens differ at steps "
                             f"with margin > 2 x {delta:.4f}")
    return dict(delta=delta, top=cached.abs().max().item(),
                sure=int(sure.sum()), agree=int(agree.sum()),
                steps=agree.numel(), tokens=seq.shape[1])


def checked_attention(worst: dict):
    """Wrap ops' attention kernels so that every call of the path is also
    computed by the plain version on the same inputs; the largest
    per-row relative difference (row_rel) per kernel goes into
    ``worst``.  Returns the function that restores them."""
    from repro_torch.kernels import attention, decode_attention, ops
    real = (ops.flash_attention, ops.decode_attention)

    def flash(q, k, v, **kw):
        out = real[0](q, k, v, **kw)
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0),
                                       row_rel(out, attention.
                                               flash_attention_plain(
                                                   q, k, v, **kw)))
        return out

    def decode(q, k, v, kv_len, **kw):
        out = real[1](q, k, v, kv_len, **kw)
        worst["decode_attention"] = max(worst.get("decode_attention", 0.0),
                                        row_rel(out, decode_attention.
                                                decode_attention_plain(
                                                    q, k, v, kv_len, **kw)))
        return out

    ops.flash_attention, ops.decode_attention = flash, decode

    def restore():
        ops.flash_attention, ops.decode_attention = real
    return restore


def device_profile(fn, label: str, top: int = 6) -> None:
    """Run ``fn`` once under torch.profiler: wall time, device time summed
    over kernels and copies, the device's idle share, and the kernels that
    take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for name, us in device_events(prof):
        count, total = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, total + us)
    if not by_name:
        ms = time_ms(fn, reps=1)
        log("serve", f"profile {label}: the profiler recorded no device "
                     f"time; {ms:.1f} ms by CUDA events")
        return
    total_ms = sum(t for _, t in by_name.values()) / 1e3
    log("serve", f"profile {label}: wall {wall_ms:.1f} ms (under the "
                 f"profiler), device {total_ms:.1f} ms, idle share "
                 f"{max(0.0, 1 - total_ms / wall_ms):.3f}")
    for name, (count, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
        log("serve", f"  {us / 1e3:9.2f} ms  {count:5d} x  {name[:90]}")


def serve_streams_check(model, params, prompt, out, alone, n_layers: int,
                        dev) -> dict:
    """(d) ``launch/serve.py``'s streams path: 2 worker threads over the
    shared weights, each its own Server and session on one pool; each
    stream's tokens are the dfu run's first 8, each migrates its cache
    once and reuses it 7 times, every flash launch takes the wgmma
    path.  The Server's cache is not placed through the offload
    runtime, so it charges the pool nothing: (d) checks concurrent
    Servers over shared weights, not the pool's accounting, and asserts
    that every pool count stays 0 so that a change which starts charging
    the pool shows here.  Throughput is set beside ``alone`` (the dfu
    run's ServeStats) on two yardsticks: decode tokens over the decode
    window (from the first stream's decode start to the last stream's
    end, against one stream's decode time) and tokens over the whole
    wall, prefill included (against one stream's prefill plus decode).
    Returns the launches."""
    import torch
    from repro_torch.core.residency import SharedDevicePool
    from repro_torch.kernels import attention
    from repro_torch.launch.serve import serve_streams
    from repro_torch.train import ServeConfig
    pool = SharedDevicePool(STREAMS * SERVE_CACHE_BYTES + (1 << 30),
                            name="serve")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    results = serve_streams(model, params, ServeConfig(
        max_len=SERVE_LEN, offload_policy="dfu"), prompt, STREAM_GEN,
        STREAMS, pool, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    for i, (toks, st, row, _) in enumerate(results):
        if not torch.equal(toks, out[:, :STREAM_GEN]):
            raise AssertionError(f"serve streams: stream-{i} tokens "
                                 f"{toks.tolist()} != dfu's first "
                                 f"{STREAM_GEN} {out[:, :STREAM_GEN].tolist()}")
        if (st.migrations, st.cache_reuses) != (1, STREAM_GEN - 1):
            raise AssertionError(f"serve streams: stream-{i} migrations/"
                                 f"reuses {st.migrations}/{st.cache_reuses}")
        if row is None or any(v for k, v in row.items() if k != "quota"):
            raise AssertionError(f"serve streams: stream-{i}'s pool row "
                                 f"{row}; the cache charges no pool yet, "
                                 f"so every count must be 0")
    if (pool.places, pool.evictions, pool.refetches) != (0, 0, 0):
        raise AssertionError(f"serve streams: pool places/evictions/"
                             f"refetches {pool.places}/{pool.evictions}/"
                             f"{pool.refetches}, want 0/0/0")
    if (got["flash_attention"] != STREAMS * n_layers
            or attention.launches_by_path[attention.WGMMA]
            != got["flash_attention"]):
        raise AssertionError(f"serve streams: flash launches {got} by path "
                             f"{attention.launches_by_path}; want "
                             f"{STREAMS} x {n_layers}, all on wgmma")
    tokens = sum(st.tokens for _, st, _, _ in results)
    decode_from = min(t1 - st.decode_s for _, st, _, (_, t1) in results)
    decode_to = max(t1 for _, _, _, (_, t1) in results)
    window = decode_to - decode_from
    for i, (_, st, row, (s0, s1)) in enumerate(results):
        log("serve", f"(d) stream-{i}: prefill {st.prefill_s:.3f} s, "
                     f"decode {st.decode_s:.3f} s for {STREAM_GEN - 1} "
                     f"steps ({st.tokens / st.decode_s:.2f} decode tokens/s, "
                     f"{st.tokens / (s1 - s0):.2f} tokens/s over its "
                     f"{s1 - s0:.3f} s); migrations {st.migrations}, "
                     f"reuses {st.cache_reuses}; pool row {row}")
    one_decode = alone.tokens / alone.decode_s
    one_wall = alone.tokens / (alone.prefill_s + alone.decode_s)
    log("serve", f"(d) {STREAMS} streams x {STREAM_GEN} tokens: tokens "
                 f"equal the dfu run's first {STREAM_GEN}; decode window "
                 f"{window:.3f} s: {tokens / window:.2f} decode tokens/s "
                 f"against one stream's {one_decode:.2f} "
                 f"({tokens / window / one_decode:.3f}x); whole wall "
                 f"{wall:.3f} s: {tokens / wall:.2f} tokens/s against one "
                 f"stream's {one_wall:.2f} over prefill + decode "
                 f"({tokens / wall / one_wall:.3f}x); launches {got}; peak "
                 f"device memory {peak / 1e9:.2f} GB; pool counts all 0 "
                 f"(the cache charges no pool)")
    for line in pool.report().splitlines():
        log("serve", f"(d) {line}")
    return got


def phase_serve(dev) -> dict:
    """gemma2-9b at full width through the serving loop: dfu, then
    memcopy with every attention kernel call held to its plain version
    (these two runs are the main path, and their launches are returned),
    then the cross-check between the cached steps and a forward without a
    cache over two layers, then a device profile of one prefill and one
    decode step."""
    import dataclasses
    import torch
    from repro_torch.kernels import attention, decode_attention, gemm
    from repro_torch.models import Model, get_config
    cfg = dataclasses.replace(get_config("gemma2_9b"), prefill_fresh_kv=True)
    model = Model.from_config(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log("serve", f"{cfg.name}: {cfg.n_layers} layers, d_model "
                 f"{cfg.d_model}, vocab {cfg.vocab}, "
                 f"{sum(p.numel() for p in params.parameters())} parameters "
                 f"({sum(p.nbytes for p in params.parameters()) / 1e9:.2f} "
                 f"GB) made on the card in {time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator().manual_seed(1))
    n_global = cfg.n_layers // 2
    # q, k, v, o, gate, up, down per layer, and the tied vocab head
    gemms_per_forward = 7 * cfg.n_layers + 1
    launched = {}

    def add(got):
        for name, n in got.items():
            launched[name] = launched.get(name, 0) + n

    # dfu: one migration of the cache, then reuse
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    srv, out, _ = generate_keeping(model, params, "dfu", SERVE_GEN, prompt,
                                   dev)
    got = counts()
    reduces = gemm.reduce_launches
    flash_paths = dict(attention.launches_by_path)
    flash_copies = attention.copies
    decode_copies = decode_attention.copies
    peak = torch.cuda.max_memory_allocated()
    add(got)
    st = srv.stats
    want = (SERVE_CACHE_BYTES, 0, 1, SERVE_GEN - 1)
    have = (st.bytes_host_to_dev, st.bytes_dev_to_host, st.migrations,
            st.cache_reuses)
    if have != want:
        raise AssertionError(f"serve dfu: (h->d, d->h, migrations, reuses) "
                             f"{have} != {want}")
    if (got["flash_attention"], got["decode_attention"], got["gemm"]) != \
            (cfg.n_layers, n_global * (SERVE_GEN - 1),
             gemms_per_forward * SERVE_GEN):
        raise AssertionError(f"serve dfu: launches {got}, want flash "
                             f"{cfg.n_layers} (prefill), decode "
                             f"{n_global} x {SERVE_GEN - 1} and gemm "
                             f"{gemms_per_forward} x {SERVE_GEN}")
    if flash_paths[attention.WGMMA] != got["flash_attention"]:
        raise AssertionError(f"serve dfu: flash launches by path "
                             f"{flash_paths}; all {got['flash_attention']} "
                             f"must take the wgmma path")
    if decode_copies:
        raise AssertionError(f"serve dfu: decode_attention copied the "
                             f"cache {decode_copies} times; the cache's "
                             f"views must go in uncopied")
    if tuple(out.shape) != (SERVE_BATCH, SERVE_GEN) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"serve dfu: tokens {out}")
    log("serve", f"dfu generate({SERVE_BATCH} x {SERVE_PROMPT}, "
                 f"{SERVE_GEN}): prefill {st.prefill_s:.3f} s, decode "
                 f"{st.decode_s:.3f} s for {SERVE_GEN - 1} steps "
                 f"({st.decode_s / (SERVE_GEN - 1) * 1e3:.1f} ms per step, "
                 f"{st.tokens / st.decode_s:.2f} tokens/s); h->d "
                 f"{st.bytes_host_to_dev} B, d->h {st.bytes_dev_to_host} B, "
                 f"migrations {st.migrations}, reuses {st.cache_reuses}; "
                 f"launches {got} (gemm {gemms_per_forward} per forward, "
                 f"plus {reduces} split-K reductions; flash by path "
                 f"{flash_paths}, {flash_copies} operand copies; decode "
                 f"{decode_copies} cache copies); peak "
                 f"device memory "
                 f"{peak / 1e9:.2f} GB")
    del srv
    add(serve_streams_check(model, params, prompt, out, st, cfg.n_layers,
                            dev))

    # memcopy: the cache round-trips around the prefill and every step;
    # each attention kernel call is also computed by its plain version
    worst = {}
    restore = checked_attention(worst)
    reset_counts()
    try:
        mc, out_mc, _ = generate_keeping(model, params, "memcopy", 4,
                                         prompt, dev)
    finally:
        restore()
    got = counts()
    add(got)
    st = mc.stats
    if attention.launches_by_path[attention.WGMMA] != got["flash_attention"]:
        raise AssertionError(f"serve memcopy: flash launches by path "
                             f"{attention.launches_by_path}; all must take "
                             f"the wgmma path")
    if decode_attention.copies:
        raise AssertionError(f"serve memcopy: decode_attention copied the "
                             f"cache {decode_attention.copies} times")
    if got["gemm"] != gemms_per_forward * 4:
        raise AssertionError(f"serve memcopy: {got['gemm']} gemm launches, "
                             f"want {gemms_per_forward} x 4")
    have = (st.bytes_host_to_dev, st.bytes_dev_to_host)
    if have != (4 * SERVE_CACHE_BYTES, 4 * SERVE_CACHE_BYTES):
        raise AssertionError(f"serve memcopy: (h->d, d->h) {have} != 4 x "
                             f"{SERVE_CACHE_BYTES}")
    if not torch.equal(out_mc, out[:, :4]):
        raise AssertionError(f"serve memcopy tokens {out_mc.tolist()} != "
                             f"dfu's {out[:, :4].tolist()}")
    if set(worst) != {"flash_attention", "decode_attention"} or \
            max(worst.values()) > ATTN_TOL:
        raise AssertionError(f"serve memcopy: kernels vs plain in the "
                             f"path {worst} (tol {ATTN_TOL})")
    log("serve", f"memcopy generate(.., 4): prefill {st.prefill_s:.3f} s "
                 f"and decode {st.decode_s:.3f} s for 3 steps (each with "
                 f"the plain versions beside the kernels); h->d "
                 f"{st.bytes_host_to_dev} B, d->h {st.bytes_dev_to_host} B "
                 f"(4 x the cache); tokens equal dfu's first 4; every "
                 f"kernel call vs its plain version on the same inputs: "
                 + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items()))
                 + f" (tol {ATTN_TOL:g}); launches {got}")
    del mc

    # cross-check at the same widths over two layers; its launches are
    # asserted here and kept out of the main path's counts
    small = dataclasses.replace(cfg, n_layers=CROSS_LAYERS)
    smodel = Model.from_config(small)
    sparams = smodel.init(torch.Generator(device=dev).manual_seed(0), dev)
    reset_counts()
    _, sout, scached = generate_keeping(smodel, sparams, "dfu", SERVE_GEN,
                                        prompt, dev)
    cut = cross_check(smodel, sparams, prompt, sout, scached, dev)
    got = counts()
    want = (2 * CROSS_LAYERS, CROSS_LAYERS // 2 * (SERVE_GEN - 1))
    if (got["flash_attention"], got["decode_attention"]) != want:
        raise AssertionError(f"serve cross-check: launches {got}, want "
                             f"(flash, decode) {want}")
    if cut["sure"] == 0:
        raise AssertionError(f"serve cross-check at {CROSS_LAYERS} layers: "
                             f"no step has a margin over 2 x "
                             f"{cut['delta']:.4f}")
    log("serve", f"cross-check, {CROSS_LAYERS} layers: forward without a "
                 f"cache over {cut['tokens']} tokens vs the {SERVE_GEN} "
                 f"cached steps: max|dlogit| {cut['delta']:.5f} (logits up "
                 f"to {cut['top']:.2f}); tokens agree at all {cut['sure']} "
                 f"of {cut['steps']} steps whose top-2 margin exceeds 2 x "
                 f"max|dlogit| ({cut['agree']} of {cut['steps']} agree in "
                 f"all); launches {got} (not counted as the main path's)")
    del sparams, smodel, scached

    # where a step's device time goes (launches here are not counted)
    cache = model.init_cache(SERVE_BATCH, SERVE_LEN, device=dev)
    tok = out[:, :1]
    with torch.no_grad():
        device_profile(lambda: model.forward(
            params, prompt.to(dev), cache=cache, cache_pos=0),
            f"one prefill forward ({SERVE_BATCH} x {SERVE_PROMPT})")
        device_profile(lambda: model.forward(
            params, tok, cache=cache, cache_pos=SERVE_PROMPT),
            f"one decode step (kv_len {SERVE_PROMPT + 1})")
    del params, cache
    torch.cuda.empty_cache()
    return launched


#: the runtime phase's (a): LSMS's KKR plane (complex128, n 6912) dealt
#: over 4 tiers of the one card; its trsm solves LSMS's triangle against
#: 256 columns, 4 panels of 64 (_grid1d(4, 256) at tile_min 64)
RUNTIME_N, RUNTIME_RHS, RUNTIME_TIERS = 6912, 256, 4
#: (a) tiles against the same call on one tier: both sum every element
#: over the same K in float64 on the same kernel, so they agree to a few
#: roundings; 1e-12 of max|.| is ~5000 eps64 and still catches a lost
#: or doubled tile (an error of order 1)
TILE_TOL = 1e-12
#: (a) PARSEC's widths (the venue phase's): psi 93536 x 2400, the
#: projection hpsi_blk.T @ psi over 32 columns
PARSEC_K, PARSEC_N, PARSEC_BLK = 93536, 2400, 32
#: (b) the breaker walk's float64 gemm edge, and its cooldown (ms)
WALK_N, WALK_COOLDOWN_MS = 4096, 200.0
#: (b) the real OOM: room left on the card above what is reserved, for
#: one float64 6912^2 operand (382.2 MB) and a call's small output and
#: workspace, not for two such operands
OOM_ROOM = 512 << 20
#: (c) tenancy: 3 threads, each 12 float64 4096^2 gemms over 4 host-born
#: operand pairs of its own (1.07 GB per tenant) on one 2 GiB pool
TENANTS, TENANT_CALLS, TENANT_PAIRS, POOL_BYTES = 3, 12, 4, 2 << 30
#: (d) concurrent serving streams over shared weights, tokens each
STREAMS, STREAM_GEN = 2, 8


def expect_launches(where: str, got: dict, want: dict) -> None:
    """The launches of the named kernels in one run, exactly."""
    have = {k: got.get(k, 0) for k in want}
    if have != want:
        raise AssertionError(f"{where}: launches {have} != {want}")


def tier_snapshot(stats) -> dict:
    return {d: (v.tiles, v.moved_bytes, v.affinity_hits, v.evictions)
            for d, v in sorted(stats.per_device.items())}


def tile_sequence(cfg, dev, ops: dict) -> dict:
    """The runtime phase's (a) sequence in one session of ``cfg``: the
    LSMS zgemm twice, the LSMS trsm, then on the pallas venue the split3
    PARSEC projection and the PARSEC syrk.  Each call is synchronized and
    timed; returns outputs, walls, launches, per-tier snapshots after
    each call, the session's stats and its trace."""
    import torch
    import repro_torch
    from repro_torch.core import blas
    outs, walls, launches, tiers = {}, {}, {}, {}
    with repro_torch.session(cfg, device=dev, intercept=False) as s:
        def timed(name, fn):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            launches[name] = counts()
            tiers[name] = tier_snapshot(s.stats)

        timed("zgemm 1", lambda: blas.gemm(ops["A"], ops["B"]))
        timed("zgemm 2", lambda: blas.gemm(ops["A"], ops["B"]))
        timed("dtrsm", lambda: blas.trsm(ops["L"], ops["R"]))
        s.reconfigure(kernel_path=True, precision="split3")
        timed("split3", lambda: blas.gemm(ops["hpsi"], ops["psi"],
                                          trans_a="T"))
        s.reconfigure(precision="")
        timed("dsyrk", lambda: blas.syrk(ops["psi"], trans="T"))
        stats, trace = s.stats, s.trace
    return dict(outs=outs, walls=walls, launches=launches, tiers=tiers,
                stats=stats, trace=trace, cfg=cfg)


def runtime_tiles(dev, ops: dict, launched: dict) -> dict:
    """(a): the tile scheduler at LSMS's width on 4 tiers, each call
    against the same sequence on one tier, and the trace replayed."""
    import torch
    from repro_torch import OffloadConfig
    from repro_torch.core import precision as prc
    from repro_torch.memtier import MemTierSimulator
    n, t = RUNTIME_N, RUNTIME_TIERS
    base = dict(policy="dfu", threshold=500.0, sync=True)
    one = tile_sequence(OffloadConfig(**base), dev, ops)
    four = tile_sequence(OffloadConfig(**base, devices=t), dev, ops)
    for run in (one, four):
        for got in run["launches"].values():
            for name, k in got.items():
                launched[name] = launched.get(name, 0) + k
    st, tiers, trace = four["stats"], four["tiers"], four["trace"]
    no_faults(st, "runtime (a)")
    no_faults(one["stats"], "runtime (a) one tier")
    blk = (n // 2) * n * 16                 # one c128 half-plane block
    # zgemm: a 2 x 2 grid, one tile per tier, 2 blocks moved per tier
    calls = [c.devices for c in trace.calls]
    if calls[0] != tuple(range(t)) or calls[1] != calls[0]:
        raise AssertionError(f"runtime (a) zgemm tiers {calls[:2]}")
    first = {d: (1, 2 * blk, 0, 0) for d in range(t)}
    second = {d: (2, 2 * blk, 2, 0) for d in range(t)}
    if tiers["zgemm 1"] != first or tiers["zgemm 2"] != second:
        raise AssertionError(f"runtime (a) zgemm per tier "
                             f"{tiers['zgemm 1']} then {tiers['zgemm 2']},"
                             f" want {first} then {second}")
    z = st.per_routine["zgemm"]
    if (z.sharded, z.tiles, z.bytes_in) != (2, 2 * t, t * 2 * blk):
        raise AssertionError(f"runtime (a) zgemm sharded/tiles/bytes "
                             f"{(z.sharded, z.tiles, z.bytes_in)}")
    # c128 runs 4 real products (4M) per tile on gemm.cu
    expect_launches("runtime (a) zgemm", four["launches"]["zgemm 1"],
                    {"gemm": 4 * t, "trsm": 0})
    # trsm: 4 panels, the triangle replicated on every tier
    tri_b = n * n * 8
    panel_b = n * (RUNTIME_RHS // t) * 8
    moved = {d: four["tiers"]["dtrsm"][d][1] - second[d][1]
             for d in range(t)}
    if moved != {d: tri_b + panel_b for d in range(t)}:
        raise AssertionError(f"runtime (a) trsm moved per tier {moved}, "
                             f"want the triangle {tri_b} + a panel "
                             f"{panel_b} each")
    expect_launches("runtime (a) trsm", four["launches"]["dtrsm"],
                    {"trsm": t})
    tr = st.per_routine["dtrsm"]
    if (tr.sharded, tr.tiles) != (1, t):
        raise AssertionError(f"runtime (a) trsm sharded/tiles "
                             f"{(tr.sharded, tr.tiles)}")
    # split3 on the pallas venue: the fused split kernel, 2 launches per
    # tile product; syrk tiles the masked full product on gemm.cu
    sp_tiles = len(trace.calls[3].devices)
    expect_launches("runtime (a) split3", four["launches"]["split3"],
                    {"split_gemm": SPLIT3_LAUNCHES * sp_tiles})
    sy_tiles = len(trace.calls[4].devices)
    expect_launches("runtime (a) syrk", four["launches"]["dsyrk"],
                    {"gemm": sy_tiles, "syrk": 0})
    if (trace.calls[3].precision, trace.calls[3].venue,
            trace.calls[4].venue) != ("split3", "pallas", "pallas"):
        raise AssertionError(f"runtime (a) venue tags "
                             f"{[(c.venue, c.precision) for c in trace.calls]}")
    if sy_tiles != 6 or sp_tiles < 2:
        raise AssertionError(f"runtime (a) split3 tiles {sp_tiles}, syrk "
                             f"tiles {sy_tiles} (want >= 2 and 6)")
    expect_launches("runtime (a) syrk on one tier",
                    one["launches"]["dsyrk"], {"syrk": 1, "gemm": 0})
    errs = {}
    for name in four["outs"]:
        _, errs[name] = rel_err(four["outs"][name], one["outs"][name])
    split_bound = prc.error_bound("split3", PARSEC_K)
    limits = {"zgemm 1": TILE_TOL, "zgemm 2": TILE_TOL,
              "dtrsm": TRSM_TOL["float64"], "split3": split_bound,
              "dsyrk": TOL["float64"]}
    for name, lim in limits.items():
        if not errs[name] <= lim:
            raise AssertionError(f"runtime (a) {name}: 4 tiers vs 1 tier "
                                 f"rel err {errs[name]:.3e} > {lim:g}")
    # the trace replayed on 4 tiers: the tile schedule, the offloaded
    # calls and the (absent) fault counters come back exactly
    rep = MemTierSimulator.from_config(four["cfg"]).run(trace)
    per_tier = {}
    for call in trace.calls:
        for d in call.devices:
            per_tier[d] = per_tier.get(d, 0) + 1
    live_tiles = {d: v.tiles for d, v in st.per_device.items()}
    offloaded = sum(r.offloaded for r in st.per_routine.values())
    got = (rep.n_devices, per_tier, rep.offloaded_calls,
           (rep.faults, rep.retries, rep.fallbacks, rep.quarantines))
    want = (t, live_tiles, offloaded, (0, 0, 0, 0))
    if got != want:
        raise AssertionError(f"runtime (a) replay {got} != live {want}")
    for name in four["walls"]:
        log("runtime", f"(a) {name}: 4 tiers {four['walls'][name]:.3f} s, "
                       f"1 tier {one['walls'][name]:.3f} s (synchronized "
                       f"wall; the tiers share one card, so tiles "
                       f"serialize); rel err {errs[name]:.3e} (tol "
                       f"{limits[name]:g}); launches "
                       f"{four['launches'][name]}")
    log("runtime", f"(a) per tier (tiles, moved B, affinity hits, "
                   f"evictions) after zgemm 1 {tiers['zgemm 1']}, after "
                   f"zgemm 2 {tiers['zgemm 2']}, at the end "
                   f"{tier_snapshot(st)}; block {blk} B; zgemm 2 moved "
                   f"0 B; trsm moved {moved} (triangle {tri_b} + panel "
                   f"{panel_b} per tier); split3 tiles {sp_tiles}, syrk "
                   f"tiles {sy_tiles}")
    log("runtime", f"(a) zgemm 1 moved {t * 2 * blk} B: {t * blk} B of A "
                   f"(host-born) across the link, {t * blk} B of B "
                   f"(device-born) copied on the card")
    log("runtime", f"(a) replay on {t} tiers: tiles per tier {per_tier}, "
                   f"{rep.offloaded_calls} offloaded calls, faults 0 — equal "
                   f"to the live run; the simulator's own per-device "
                   f"h2d (buffer-granular) {rep.per_device_h2d} beside the "
                   f"live block movement "
                   f"{ {d: v.moved_bytes for d, v in st.per_device.items()} }")
    return four


def runtime_faults_sequence(dev, ops: dict, clean: dict,
                            launched: dict) -> None:
    """(b) 1: the (a) sequence on 4 tiers under injected transfer and
    kernel faults with retries: every result bit for bit the unfaulted
    run's, every fault retried, the counters equal to the replay's."""
    import torch
    from repro_torch import OffloadConfig
    from repro_torch.memtier import MemTierSimulator
    cfg = OffloadConfig(policy="dfu", threshold=500.0, sync=True,
                        devices=RUNTIME_TIERS,
                        faults="transfer:nth=3;kernel:nth=4", retries=2)
    run = tile_sequence(cfg, dev, ops)
    for got in run["launches"].values():
        for name, k in got.items():
            launched[name] = launched.get(name, 0) + k
    st = run["stats"]
    for name, out in run["outs"].items():
        if not torch.equal(out, clean["outs"][name]):
            raise AssertionError(f"runtime (b) {name} under faults is not "
                                 f"bit for bit the unfaulted run's")
    live = (st.faults, st.retries, st.fallbacks, st.quarantines)
    if not (st.faults > 0 and st.retries == st.faults
            and st.fallbacks == 0 and st.quarantines == 0):
        raise AssertionError(f"runtime (b) faulted sequence (faults, "
                             f"retries, fallbacks, quarantines) {live}")
    if tier_snapshot(st) != tier_snapshot(clean["stats"]):
        raise AssertionError(f"runtime (b) per tier {tier_snapshot(st)} "
                             f"!= unfaulted {tier_snapshot(clean['stats'])}")
    rep = MemTierSimulator.from_config(run["cfg"]).run(run["trace"])
    if (rep.faults, rep.retries, rep.fallbacks, rep.quarantines) != live:
        raise AssertionError(f"runtime (b) replay faults "
                             f"{(rep.faults, rep.retries, rep.fallbacks)} "
                             f"!= live {live}")
    log("runtime", f"(b) the (a) sequence under transfer:nth=3;"
                   f"kernel:nth=4, retries 2: faults {st.faults}, retries "
                   f"{st.retries}, fallbacks 0; all 5 results bit for bit "
                   f"the unfaulted run's, per-tier counters equal; replay "
                   f"faults/retries {rep.faults}/{rep.retries}; walls "
                   + ", ".join(f"{k} {v:.3f} s"
                               for k, v in run["walls"].items()))


def runtime_breaker_walk(dev, launched: dict) -> None:
    """(b) 2: the breaker walk on float64 4096^2 gemms, every result bit
    for bit the same call's under policy="cpu".  Under kernel:nth=1 with
    no retries, 3 calls fall back; the breaker does not trip, because
    each call's operand placements succeed before its kernel fails and a
    successful unit resets the consecutive count (the reference's rule,
    ``HealthTracker.ok``).  Under transfer:p=1, calls on fresh host-born
    operands fail at their first unit: the consecutive count reaches 3,
    the quarantine invalidates the placements, and the next call is
    served from the host (degraded).  After the cooldown the half-open
    probe offloads, launches gemm.cu, re-moves its operands and
    recovers."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import OffloadConfig
    from repro_torch.core import blas, host_array
    n = WALK_N
    rng = np.random.default_rng(13)
    a, b, c1, c2 = (host_array(rng.standard_normal((n, n)), torch.float64)
                    for _ in range(4))
    with repro_torch.session(OffloadConfig(policy="cpu", sync=True),
                             device=dev, intercept=False) as s0:
        want = {"ab": blas.gemm(a, b), "c1": blas.gemm(c1, b),
                "c2": blas.gemm(c2, b)}
        no_faults(s0.stats, "runtime (b) policy cpu")
    cfg = OffloadConfig(policy="dfu", threshold=500.0, sync=True,
                        faults="kernel:nth=1", retries=0, breaker=3,
                        breaker_cooldown_ms=WALK_COOLDOWN_MS)
    calls = [("ab", a), ("ab", a), ("ab", a), ("c1", c1), ("c2", c2),
             ("ab", a)]
    steps = []
    reset_counts()
    with repro_torch.session(cfg, device=dev, intercept=False) as s:
        st, rt = s.stats, s.runtime
        for i, (name, x) in enumerate(calls):
            if i == 3:
                s.reconfigure(faults="transfer:p=1")
            out = blas.gemm(x, b)
            if not torch.equal(out, want[name]):
                raise AssertionError(f"runtime (b) walk call {i + 1}: not "
                                     f"bit for bit policy=cpu's")
            steps.append((st.faults, st.fallbacks, st.quarantines,
                          rt.placements.resident_bytes,
                          rt.health.device(0).state))
        s.reconfigure(faults="")
        time.sleep(1.25 * WALK_COOLDOWN_MS / 1e3)
        moved0 = st.per_routine["dgemm"].bytes_in
        before = counts()
        probe = blas.gemm(a, b)
        got = {k: counts()[k] - before[k] for k in before}
        moved = st.per_routine["dgemm"].bytes_in - moved0
        final = (st.faults, st.fallbacks, st.quarantines, st.recoveries,
                 rt.health.device(0).state)
        refetches = s.trace.event_count("refetch")
    for name, k in counts().items():
        launched[name] = launched.get(name, 0) + k
    nbytes = n * n * 8
    want_steps = [(1, 1, 0, 2 * nbytes, "closed"),
                  (2, 2, 0, 2 * nbytes, "closed"),
                  (3, 3, 0, 2 * nbytes, "closed"),
                  (4, 4, 0, 2 * nbytes, "closed"),
                  (5, 5, 1, 0, "open"), (5, 6, 1, 0, "open")]
    if steps != want_steps:
        raise AssertionError(f"runtime (b) walk (faults, fallbacks, "
                             f"quarantines, resident B, state) {steps} != "
                             f"{want_steps}")
    if final != (5, 6, 1, 1, "closed") or moved != 2 * nbytes:
        raise AssertionError(f"runtime (b) probe: (faults, fallbacks, "
                             f"quarantines, recoveries, state) {final}, "
                             f"moved {moved} B (want 2 x {nbytes})")
    expect_launches("runtime (b) probe", got, {"gemm": 1})
    if not torch.equal(probe, want["ab"]):
        raise AssertionError("runtime (b) probe result is not bit for bit "
                             "policy=cpu's")
    log("runtime", f"(b) breaker walk, f64 {n}^2, retries 0, breaker 3: "
                   f"(faults, fallbacks, quarantines, resident B, state) "
                   f"after each call {steps} (calls 1-3 under "
                   f"kernel:nth=1, 4-5 under transfer:p=1 on fresh "
                   f"operands, 6 degraded); each result bit for bit "
                   f"policy=cpu's; after {WALK_COOLDOWN_MS:g} ms the probe "
                   f"offloaded ({got['gemm']} gemm.cu launch), re-moved "
                   f"{moved} B ({refetches} refetch events) and recovered: "
                   f"{final}")


def runtime_real_oom(dev) -> None:
    """(b) 3: a real OOM.  The card is held to its reservation plus
    512 MB.  A dfu session with breaker=1 places a host-born float64
    6912^2 operand ``x`` (382.2 MB) by first touch, so the next host-born
    operand ``a`` of that size cannot be placed: one DeviceOOMError, no
    retry, and the breaker trips at once.  Its quarantine invalidates
    ``x``'s placement, which must free its HBM: the fallback's host path
    streams ``a`` to the card into that room, and its result is bit for
    bit policy=cpu's under the same limit.  (The host path streams too,
    so a placement that fails for lack of room only gets through once
    room is freed: without the quarantine the fallback's own
    torch.cuda.OutOfMemoryError would propagate.)"""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import OffloadConfig
    from repro_torch.core import blas, host_array
    n = RUNTIME_N
    rng = np.random.default_rng(17)
    x, a = (host_array(rng.standard_normal((n, n)), torch.float64)
            for _ in range(2))
    b = torch.randn(n, 64, dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(17))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    limit = torch.cuda.memory_reserved(dev) + OOM_ROOM
    torch.cuda.set_per_process_memory_fraction(limit / total, dev)
    try:
        with repro_torch.session(OffloadConfig(policy="cpu"), device=dev,
                                 intercept=False):
            want = blas.gemm(a, b)
        with repro_torch.session(OffloadConfig(policy="dfu",
                                               threshold=500.0,
                                               breaker=1),
                                 device=dev, intercept=False) as s:
            first = blas.gemm(x, b)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
            got = blas.gemm(a, b)
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated(dev)
            st = s.stats
            events = [(e.kind, e.store) for e in s.trace.events
                      if e.kind in ("fault", "retry", "quarantine",
                                    "fallback")]
        del first
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        torch.cuda.empty_cache()
    have = (st.faults, st.retries, st.quarantines, st.fallbacks)
    want_events = [("fault", "oom@dev0"), ("quarantine", "dev0"),
                   ("fallback", "oom@dev0")]
    if have != (1, 0, 1, 1) or events != want_events:
        raise AssertionError(f"runtime (b) real OOM: (faults, retries, "
                             f"quarantines, fallbacks) {have}, events "
                             f"{events}")
    # x's placement (382.2 MB) is freed; the result (3.5 MB) is held
    freed = held - after
    if not freed >= x.nbytes - got.nbytes:
        raise AssertionError(f"runtime (b) real OOM: the quarantine freed "
                             f"{freed} B of device memory, not x's "
                             f"{x.nbytes} B")
    if got.device.type != "cuda" or not torch.equal(got, want):
        raise AssertionError("runtime (b) real OOM: the fallback is not "
                             "bit for bit policy=cpu's result on the card")
    _, rel = rel_err(got, a.to(dev) @ b)
    if not rel <= TOL["float64"]:
        raise AssertionError(f"runtime (b) real OOM result rel err {rel}")
    log("runtime", f"(b) real OOM: card limit {limit / 1e9:.2f} GB of "
                   f"{total / 1e9:.1f} GB; x ({x.nbytes} B) placed, then "
                   f"DeviceOOMError on placing a, 0 retries, breaker=1 "
                   f"quarantine freed {freed} B, 1 fallback streamed a on "
                   f"the card, bit for bit policy=cpu's (rel err vs torch "
                   f"{rel:.3e}); events {events}")


def runtime_tenancy(dev, launched: dict) -> None:
    """(c): 3 threads, each a named session on one 2 GiB pool, each 12
    float64 4096^2 gemms over 4 host-born operand pairs of its own.  The
    tenants arrive in turn (each once the one before has placed its
    operands), so a later tenant's placements must evict an earlier
    tenant's residents; the pool's ledger is sampled between calls."""
    import threading
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import OffloadConfig
    from repro_torch.core import blas, host_array
    from repro_torch.core.residency import SharedDevicePool
    n = WALK_N
    cfg = OffloadConfig(policy="dfu", threshold=500.0)
    ops = []
    for i in range(TENANTS):
        rng = np.random.default_rng(100 + i)
        ops.append([tuple(host_array(rng.standard_normal((n, n)),
                                     torch.float64) for _ in range(2))
                    for _ in range(TENANT_PAIRS)])
    pool = SharedDevicePool(POOL_BYTES, name="tenancy")
    sessions = [repro_torch.session(cfg, device=dev, intercept=False,
                                    record_trace=False, name=f"tenant-{i}",
                                    pool=pool) for i in range(TENANTS)]
    owners, samples, outs = {}, [], {}
    cross = [0]
    lock = threading.Lock()
    for i, s in enumerate(sessions):
        store = s.runtime.placements
        hook = store.on_evict

        def on_evict(*args, i=i, hook=hook):
            if threading.current_thread() is not owners.get(i):
                with lock:
                    cross[0] += 1
            hook(*args)
        store.on_evict = on_evict

    def sample():
        # between calls: under every tenant's runtime lock no call is in
        # flight, so the ledger is settled
        locks = [s.runtime._lock for s in sessions]
        for lk in locks:
            lk.acquire()
        try:
            resident = sum(st.resident_bytes for s in sessions
                           for st in (s.runtime.placements,
                                      *s.runtime.block_stores))
            samples.append((pool.usage(), resident))
        finally:
            for lk in reversed(locks):
                lk.release()

    errors = []
    # tenants arrive in turn: each starts once the one before it has run
    # its first TENANT_PAIRS calls, then all run at once
    arrived = [threading.Event() for _ in range(TENANTS)]

    def worker(i):
        try:
            owners[i] = threading.current_thread()
            if i and not arrived[i - 1].wait(300):
                raise AssertionError(f"tenant-{i - 1} never arrived")
            mine = []
            with sessions[i].scope():
                for k in range(TENANT_CALLS):
                    mine.append(blas.gemm(*ops[i][k % TENANT_PAIRS]))
                    sample()
                    if k + 1 == TENANT_PAIRS:
                        arrived[i].set()
                sessions[i].sync()
            outs[i] = mine
        except BaseException as exc:   # noqa: BLE001 - re-raised below
            for ev in arrived:
                ev.set()
            errors.append(exc)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    reset_counts()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(TENANTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    got = counts()
    for name, k in got.items():
        launched[name] = launched.get(name, 0) + k
    held = sum(o.nbytes for mine in outs.values() for o in mine)
    growth = torch.cuda.memory_allocated(dev) - base - held
    usage, rows = pool.usage(), pool.tenant_stats()
    resident = sum(st.resident_bytes for s in sessions
                   for st in (s.runtime.placements,
                              *s.runtime.block_stores))
    offloaded = sum(s.stats.per_routine["dgemm"].offloaded
                    for s in sessions)
    for s in sessions:
        no_faults(s.stats, f"runtime (c) {s.name}")
    report = pool.report()
    for s in sessions:
        s.close()
    bad = [x for x in samples if x[0] != x[1] or x[0] > POOL_BYTES]
    if bad or usage != resident or usage > POOL_BYTES:
        raise AssertionError(f"runtime (c) ledger vs resident bytes: "
                             f"{len(bad)} bad samples {bad[:3]}, end "
                             f"{usage} vs {resident} (pool {POOL_BYTES})")
    if cross[0] == 0:
        raise AssertionError("runtime (c): no cross-tenant eviction")
    expect_launches("runtime (c)", got, {"gemm": offloaded})
    if offloaded != TENANTS * TENANT_CALLS:
        raise AssertionError(f"runtime (c) offloaded {offloaded}")
    if growth > POOL_BYTES:
        raise AssertionError(f"runtime (c) allocator growth {growth} B "
                             f"beyond the outputs held exceeds the pool's "
                             f"{POOL_BYTES} B: evicted placements were not "
                             f"freed")
    t1 = time.perf_counter()
    for i in range(TENANTS):
        with repro_torch.session(cfg, device=dev, intercept=False,
                                 record_trace=False):
            for k in range(TENANT_CALLS):
                if not torch.equal(blas.gemm(*ops[i][k % TENANT_PAIRS]),
                                   outs[i][k]):
                    raise AssertionError(f"runtime (c) tenant-{i} call "
                                         f"{k}: not bit for bit its "
                                         f"single-threaded run")
    torch.cuda.synchronize()
    serial = time.perf_counter() - t1
    evictions = sum(r["evictions"] for r in rows.values())
    log("runtime", f"(c) {TENANTS} threads x {TENANT_CALLS} f64 {n}^2 "
                   f"gemms on a {POOL_BYTES} B pool: ledger == resident "
                   f"bytes <= pool at all {len(samples)} samples (max "
                   f"{max(u for u, _ in samples)} B); evictions "
                   f"{evictions} ({cross[0]} cross-tenant); gemm launches "
                   f"{got['gemm']} == offloaded calls; allocator growth "
                   f"less the {held} B of outputs held: {growth} B; "
                   f"threads {wall:.3f} s against {serial:.3f} s "
                   f"serialized (with the bit-for-bit checks); results bit "
                   f"for bit each tenant's single-threaded run")
    for line in report.splitlines():
        log("runtime", f"(c) {line}")


def phase_runtime(dev) -> dict:
    """The runtime phase: a real OOM (part of (b)) first, then (a) the
    tile scheduler at LSMS's width over 4 tiers of the card, with
    PARSEC's split3 and syrk on the pallas venue, against one tier and
    replayed; (b) the (a) sequence under injection and the breaker walk;
    (c) tenancy: 3 threads on one shared pool.  Returns the launches of
    every run in it."""
    import numpy as np
    import torch
    from repro_torch.core import host_array
    n = RUNTIME_N
    launched: dict = {}
    # the real OOM first, while the allocator caches little: a free
    # remainder of a cached block could otherwise take the operand
    runtime_real_oom(dev)
    rng = np.random.default_rng(11)
    gen = torch.Generator(device=dev).manual_seed(11)
    ops = {
        "A": host_array(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)),
                        torch.complex128),
        "B": torch.randn(n, n, dtype=torch.complex128, device=dev,
                         generator=gen),
        "L": host_array(np.tril(rng.standard_normal((n, n)) / n)
                        + 2.0 * np.eye(n), torch.float64),
        "R": host_array(rng.standard_normal((n, RUNTIME_RHS)),
                        torch.float64),
        "psi": torch.randn(PARSEC_K, PARSEC_N, dtype=torch.float64,
                           device=dev, generator=gen),
        "hpsi": torch.randn(PARSEC_K, PARSEC_BLK, dtype=torch.float64,
                            device=dev, generator=gen),
    }
    clean = runtime_tiles(dev, ops, launched)
    runtime_faults_sequence(dev, ops, clean, launched)
    del clean, ops
    runtime_breaker_walk(dev, launched)
    runtime_tenancy(dev, launched)
    torch.cuda.empty_cache()
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
        lsms_launches, lsms_energy = phase_lsms(s, dev)
        no_faults(s.stats, "blas + lsms session")
    solver_launches = phase_solvers(dev, lsms_energy)
    venue_launches = phase_venue(dev)
    runtime_launches = phase_runtime(dev)
    serve_launches = phase_serve(dev)
    for name, row in rows.items():
        row["launches"] = (blas_launches[name] + lsms_launches[name]
                           + solver_launches[name] + venue_launches[name]
                           + runtime_launches.get(name, 0)
                           + serve_launches[name])
        log("done", f"{name} launches: blas {blas_launches[name]}, lsms "
                    f"{lsms_launches[name]}, solvers "
                    f"{solver_launches[name]}, venue {venue_launches[name]}, "
                    f"runtime {runtime_launches.get(name, 0)}, serve "
                    f"{serve_launches[name]}")
        if row["launches"] == 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 f"main path")
    log("done", f"peak device memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: rows[n][k] for k in keys}
                                  for n in KERNELS]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
