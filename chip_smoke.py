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
n = 6912 in complex128, then the kernel venue, adaptive per-site racing
and split-precision fp64 at PARSEC's production shapes (ngrid 93536,
nstates 2400, nblock 32), then the serving loop
(``repro_torch.train.Server``) on gemma2-9b at full width with a Device
First-Use decode cache.  Phases, in order:

1. build   — build and load the kernels; the card's name and power limit.
2. kernels — each kernel against its plain version, with the tolerance
             stated beside it; kernel, plain and library times; gemm on
             each of its paths, at the serve path's bf16 shapes too
             (prefill MLP, decode projections, the vocab head over the
             table's transposed view); trsm in every variant, ragged,
             batched and on an LU factor, one launch per solve; the
             fused split kernel's slices bit for bit, its exact-pass
             check and dropped-pass controls; flash attention on its
             wgmma path at the serve shape (each call repeated and held
             bit for bit to the first) and at head sizes 128 and 64 in
             bf16 and f16, and on its FMA path in float32 at the serve
             shape and in bf16 at head size 32.
3. blas    — gemm/trsm/small mm inside a DFU session; counters and one
             trsm launch asserted.
4. lsms    — run_mini(atoms=2, energies=2, scf=1, n=6912, complex128)
             inside the same session; counters, residual and launches
             asserted; the loop's wall split into intercepted BLAS time
             and the rest.
5. venue   — (a) kernel_path + adaptive: 8 calls of blas.syrk(psi,
             trans="T") at one call site race host/xla/pallas and lock;
             (b) kernel_path + precision="auto": intercepted
             torch.matmul(hpsi_blk.T, psi) runs split3 on the pallas
             venue, within its a-priori bound; (c) a cancelling dgemm
             escalates to native fp64.  One session each.
6. serve   — gemma2-9b (42 layers, d_model 3584, vocab 256000, bf16,
             prefill_fresh_kv) with seeded random weights, batch 2 x
             4608 prompt tokens: generate 16 under dfu and 4 under
             memcopy (every attention kernel call there also held to its
             plain version), byte/migration/reuse counts and kernel
             launches asserted, every flash launch on the wgmma path;
             then, at the same widths over 2 layers,
             a forward without a cache over the prompt and 15 generated
             tokens against the cached steps' logits; a device profile
             of one prefill and one decode step.

The kernels line's launches are those of the main path's runs: the BLAS
and LSMS phases, the venue phase's (a)-(c), and the serve phase's dfu
and memcopy runs, each with the counts set to 0 just before it.  The
cross-check's and the profile's launches are not among them.
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
#: repeats of each serve-shape flash call held bit for bit against the
#: first: the kernel's arithmetic order is fixed, so a race in its
#: pipeline's barriers would show as a difference
FLASH_REPEATS = 100
#: gemma2-9b serve cell: batch, prompt (past the 4096 window), generation
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 4608, 16
SERVE_LEN = SERVE_PROMPT + SERVE_GEN
#: its decode cache: 2 period positions x (k, v), each (21 groups, batch,
#: 8 KV heads, SERVE_LEN slots, head size 256) in bf16
SERVE_CACHE_BYTES = 4 * 21 * SERVE_BATCH * 8 * SERVE_LEN * 256 * 2
assert SERVE_CACHE_BYTES == 3_181_903_872


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


def variants(ptxas_log: str) -> list:
    """Per entry function of one source's ``ptxas -v`` log: its template
    arguments (mangled, e.g. ``ddLb1`` = double in, double
    accumulator, TRANS true), registers,
    shared memory, stack and spill bytes, and how many 256-thread blocks
    an H100 SM holds by registers, shared memory and threads (65536
    registers allocated 8 per thread at a time, 228 KiB of shared memory
    with 1 KiB reserved per block, 2048 threads)."""
    import re
    out, cur = [], None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            t = re.search(r"\d*([a-z][a-z0-9_]*_kernel)I(\w+?)E+v",
                          m.group(1))
            cur = dict(name=f"{t.group(1)}<{t.group(2)}>" if t
                       else m.group(1), stack=0, spill=0)
            out.append(cur)
        elif cur is not None and "stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            cur["stack"], cur["spill"] = nums[0], nums[1]
        elif cur is not None and "registers" in ln:
            cur["regs"] = int(re.search(r"Used (\d+) registers", ln)[1])
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(sm[1]) if sm else 0
            cur["blocks"] = min(65536 // (-(-cur["regs"] // 8) * 8 * 256),
                                233472 // (cur["smem"] + 1024), 2048 // 256)
    return out


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
            t = re.search(r"\d*([a-z][a-z0-9_]*_kernel)I(\w+?)E+v", name)
            out.append((f"{t.group(1)}<{t.group(2)}>" if t else name[:60],
                        mma, len(re.findall(r"WARPGROUP\.DEPBAR", func))))
    return out


def phase_build():
    from repro_torch.kernels import compat
    t0 = time.perf_counter()
    paths = compat.build_all()
    secs = time.perf_counter() - t0
    for name, path in sorted(paths.items()):
        log("build", f"{name}: {path.name}")
        for v in variants(compat.BUILD_LOG.get(name, "")):
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


def trsm_times(a, b, label: str, plain_reps: int) -> dict:
    """The same for a lower-left solve: m*m*n operations; the triangle
    read once, B read once, X written once.  The plain version is the
    kernel's block-row order (trsm_dataflow_plain); each timed kernel
    call is one launch after one memset of its flags."""
    from repro_torch.kernels import ref, trsm
    m, n = b.shape
    ms = time_ms(lambda: trsm.trsm(a, b), reps=5)
    plain_ms = time_ms(lambda: trsm.trsm_dataflow_plain(a, b),
                       reps=plain_reps)
    lib_ms = time_ms(lambda: ref.trsm(a, b), reps=5)
    bms, by = bound(float(m) * m * n,
                    a.element_size() * (m * (m + 1) / 2 + 2 * m * n),
                    str(a.dtype)[6:])
    log("kernels", f"trsm {str(a.dtype)[6:]} {label}: kernel {ms:.3f} ms "
                   f"({trsm.units(m, n, 1)} blocks, one launch), "
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
    serve_gemm_checks(dev)

    rows = {"gemm": gemm_row, "trsm": phase_kernels_trsm(dev, gen)}
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
    ms = time_ms(lambda: decode_attention.decode_attention(q, k, v, kv_len,
                                                           **kw), reps=50)
    plain_ms = time_ms(lambda: decode_attention.decode_attention_plain(
        q, k, v, kv_len, **kw), reps=10)
    live = (torch.arange(s_len, device=dev) < kv_len)[None, None, None]
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=live), reps=50)
    nbytes = 2 * (2 * b * hkv * kv_len * d + 2 * b * hq * d)
    bms, by = bound(4.0 * b * hq * d * kv_len, nbytes, "bfloat16")
    n_chunks = -(-kv_len // 256)
    log("kernels", f"decode_attention: kernel {ms:.4f} ms "
                   f"({nbytes / ms / 1e6:.1f} GB/s; {n_chunks} x {b * hkv} "
                   f"blocks on 132 SMs, then {b * hq} combine blocks), plain "
                   f"{plain_ms:.3f} ms, sdpa (kv_len mask, no softcap) "
                   f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
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


def phase_lsms(s, dev, n: int = 6912) -> dict:
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    events.sort(key=dev_us, reverse=True)
    if not events:
        ms = time_ms(fn, reps=1)
        log("serve", f"profile {label}: the profiler recorded no device "
                     f"time; {ms:.1f} ms by CUDA events")
        return
    log("serve", f"profile {label}: wall {wall_ms:.1f} ms (under the "
                 f"profiler), device {total_ms:.1f} ms, idle share "
                 f"{max(0.0, 1 - total_ms / wall_ms):.3f}")
    for e in events[:top]:
        log("serve", f"  {dev_us(e) / 1e3:9.2f} ms  {e.count:5d} x  "
                     f"{e.key[:90]}")


def phase_serve(dev) -> dict:
    """gemma2-9b at full width through the serving loop: dfu, then
    memcopy with every attention kernel call held to its plain version
    (these two runs are the main path, and their launches are returned),
    then the cross-check between the cached steps and a forward without a
    cache over two layers, then a device profile of one prefill and one
    decode step."""
    import dataclasses
    import torch
    from repro_torch.kernels import attention, gemm
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
                 f"{flash_paths}, {flash_copies} operand copies); peak "
                 f"device memory "
                 f"{peak / 1e9:.2f} GB")
    del srv

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
    venue_launches = phase_venue(dev)
    serve_launches = phase_serve(dev)
    for name, row in rows.items():
        row["launches"] = (blas_launches[name] + lsms_launches[name]
                           + venue_launches[name] + serve_launches[name])
        log("done", f"{name} launches: blas {blas_launches[name]}, lsms "
                    f"{lsms_launches[name]}, venue {venue_launches[name]}, "
                    f"serve {serve_launches[name]}")
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
