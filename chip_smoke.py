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
First-Use decode cache, then on the MoE and SSD models
(granite-moe-1b-a400m, mamba2-1.3b, moonshot-v1-16b-a3b cut in depth,
jamba reduced), then on the enc-dec whisper-tiny and the VLM pixtral-12b,
then training (``repro_torch.train.Trainer``) on whisper-tiny and on
qwen1.5-4b cut in depth, then the mesh paths (expert-parallel a2a,
compressed_psum, elastic restore) on a 1-rank mesh and the dry run on
the CPU, then the twins of the reference's five drivers
(``repro_torch.examples``) through their own ``main``.  Phases, in
order:

1. build   — build and load the kernels; the card's name and power limit.
2. kernels — each kernel against its plain version, with the tolerance
             stated beside it; kernel, plain and library times; gemm on
             each of its paths, at the serve path's bf16 shapes too
             (prefill MLP, decode projections, the vocab head over the
             table's transposed view); trsm in every variant, ragged,
             batched and on an LU factor, one launch per solve; syrk
             float64 on DMMA at PARSEC's shape with its K split plan,
             two calls bit for bit; PARSEC's 32 x 2400 x 93536 dgemm
             on gemm.cu's path 5 (A = h.mT, K split), two calls bit
             for bit, beside torch.matmul; the fused split kernel's slices bit
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
             native LU's, G moved once per atom; the first getrf
             captures a graph per bucket of its 27 panel heights (8),
             the three later ones replay all 27; each span's time split
             into panels, zgemm and ztrsm, the first apart from the
             replayed, beside cuSOLVER's; one replayed panel bit for bit
             the column loop run from Python); (b)
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
             memcopy, byte/migration/reuse counts and kernel launches
             asserted, every flash launch on the wgmma path.  Each decode
             loop is the Server's warm-up step, then replays of its one
             captured CUDA graph (the counterpart of the reference's
             jitted step): the replays counted; one more replay under
             sync debug mode "error" (no host sync) and one under the
             profiler, its gemm.cu, flash and decode kernels by name
             equal to the counters' amounts per replay, the replayed
             step's wall, device time and idle share; the eager check:
             the same tokens with Server._decode_step called from Python
             at host positions, bit for bit, every attention kernel call
             there also held to its plain version;
             (d) launch/serve.py's streams path: 2 worker threads over
             the shared weights, each stream's 8 tokens equal the dfu
             run's first 8; then, at the same widths over 2 layers,
             a forward without a cache over the prompt and 15 generated
             tokens against the cached steps' logits; a device profile
             of one prefill and one decode step.
9. serve_moe_ssm — the MoE and Mamba2 SSD blocks through the same loop,
             with seeded random weights made on the card: (a)
             granite-moe-1b-a400m and (b) mamba2-1.3b at full width and
             depth, batch 2 x 4096, dfu (16 tokens) and memcopy (4):
             DFU moves granite's 404,226,048 B KV cache and mamba2's
             203,833,344 B state (float32 ssm_h and bf16 conv_state, the
             same at any max_len) once, with 15 reuses; memcopy 4x each
             way; tokens equal across policies; gemm, flash and decode
             launches per forward and step (granite: 193 gemm, 24 flash
             all on wgmma at D 64, 24 decode; mamba2: 97 gemm, no
             attention); the captured step's checks and the eager check
             as in 8 (every attention call of granite's eager check
             against its plain version); the tokens each MoE layer drops
             to capacity at prefill logged; (c) moonshot-v1-16b-a3b at
             full width over 12 of its 48 layers (D 128, MHA), batch 2 x
             2048, dfu; (d) jamba-1.5-large-398b reduced, one period of
             its mixed (k, v) / (ssm_h, conv) cache, dfu.  Then gemm.cu
             on the batched expert products (paths 1 and 2, against
             torch.bmm), the router, the ragged vocab head and mamba2's
             projections, decode at D 64 and 128, flash at granite's and
             moonshot's prefill shapes; cached-vs-uncached cross-checks
             at full width over 2 layers for (a) (capacity raised to the
             token count, so nothing drops) and (b); one profiled prefill
             and decode step of (a) and (b).
10. serve_encdec_vlm — (a) whisper-tiny at full width and depth (4 + 4
             layers, vocab 51865 tied), batch 4 x 64 tokens with 1500
             ones-valued frames, dfu (16 tokens) and memcopy (4): DFU
             moves the 38,830,080 B cache (self K/V 1,966,080 B, the
             cross K/V placeholder 36,864,000 B) once with 15 reuses,
             memcopy 4x each way, tokens equal; 65 gemm launches at the
             prefill and 33 per step, 12 flash (encoder, decoder self
             and cross attention, all wgmma, non-causal at Tk 1500) and
             4 decode per step; the captured step's checks and the eager
             check as in 8; the encoder's and the cross
             attention's flash calls on their real inputs per row,
             beside a control that must fail (the plain version with the
             TPU kernel's 36 padded keys live).  (b) pixtral-12b at full
             width and depth, batch 2 x (256 patch embeddings + 3840
             tokens), prefill then decode from P + T = 4096, dfu (16)
             and memcopy (4): DFU moves the 1,347,420,160 B cache once,
             281 gemm per forward, 40 flash at D 128 on wgmma, 40 decode
             per step.  Then gemm at the whisper head's ragged N, the
             largest backward products (whisper's head backward also on
             dC padded to rows of 51872, the layout training gives it),
             pixtral's MLP and head, flash and decode at pixtral's
             shapes; pixtral's cross-check over 2 layers; a profiled
             prefill and decode step.
11. train  — before each fit, its first step's loss and every leaf's
             gradient through the kernels against the same step with
             every product and attention plain (per leaf relative L2
             error <= 3e-2), beside a control that must fail (gemm's dB
             transposed), and every kind of flash call of that step on
             its own inputs per row against plain.  (a) whisper-tiny at
             full width and depth, batch 8 x 448 tokens with 1500
             frames, 24 AdamW steps on float32 masters (each use cast to
             bf16), under deterministic algorithms, the first the
             Trainer's eager warm-up and the 23 others replays of its
             captured step: 3 gemm launches per forward product per
             step (the forward, dA, dB), 12 flash per step, per replay
             from the capture's record, the loss falling; a restart
             from the step-12 checkpoint (a new Trainer, its own
             capture) bit for bit the uninterrupted run; one step under
             remat dots (gemm 3 x, flash 2 x) and full (gemm 4 x, flash
             2 x), eager and as 3 captured steps; a replayed step under
             sync debug mode "error", profiled (kernels by name = the
             record; wall, device time, idle share) and against the same
             step eager; the host's cost per call of the autograd
             operators.  (b) qwen1.5-4b at full width over
             4 of its 40 layers, batch 4 x 1024, 5 steps at the
             reference's TrainConfig (lr 3e-4, warmup 20), 4 of them
             replays: launches, a
             finite falling loss, peak memory, each step's loss within
             1e-2 of the same fit forced plain; the witness fits at
             warmup 1, on the kernels and plain.  The main-path runs of
             10 and 11 run inside a DFU session with interception on,
             which must see no fault, retry, fallback or quarantine.
12. mesh   — the mesh paths, on a (data=1, model=1) DeviceMesh over a
             1-rank NCCL group (a FileStore under build/): (a)
             granite-moe-1b-a400m at full width and depth, batch 2 x
             4096, on plain per-rank blocks under the mesh's axis env
             with moe_impl="a2a": launch/specs.py's prefill_step, then 8
             of its decode_steps through one kernels.compat.GraphedStep
             (a warm-up, then 7 replays of one capture that holds the
             step's all-to-alls and all-reduces); 2 all-to-alls per MoE
             layer per forward (per replay from the capture's record),
             97 gemm launches per forward (the a2a body's router and
             expert products are torch.matmul and einsum, as the
             reference's), 24 flash all on wgmma, 24 decode per step;
             the tokens bit for bit the eager step's (decode_step from
             Python at host positions, fed the same tokens); the
             replayed step's checks as in 8 (no host sync, its kernels
             by name = the record; wall, device time, idle share beside
             the eager step's wall); the same steps on the scatter plan
             fed the same tokens (greedy tokens agree wherever the top-2
             margin exceeds 2 max|dlogit|); the first MoE layer's a2a
             output against its scatter output on the real hidden
             states, at a capacity with no drops, per row; (f) the same
             model's decode step as the dry run's decode cells compute
             it, on real DTensors (the parameters placed by
             param_shardings, the cache by the cache specs), captured
             and replayed likewise: its tokens bit for bit its eager
             DTensor step's, and (a)'s wherever (a)'s top-2 margin
             exceeds 2 max|dlogit|; (b)
             compressed_psum over whisper-tiny's gradient leaves, bit for
             bit compress_decompress with a zero residual; (c) a
             whisper-tiny checkpoint restored with shardings= onto the
             mesh bit for bit, each leaf a DTensor on the card; (d) the
             dry run (launch/dryrun.py) of qwen2.5-32b train_4k on the
             one-pod mesh, jamba-1.5-large-398b long_500k and
             mamba2-1.3b train_4k (8 rows per batch shard against 16
             model ranks) on the two-pod mesh, each in a CPU process of
             its own over a fake group of 512 ranks: status ok, FLOPs >
             0, both rooflines;
             (e) the dry run's counter over gemma2-9b's prefill forward
             and whisper-tiny's training step, each whole step's H100
             compute bound against the device time phases 8 and 11
             profiled in this run: bound / measured <= 1.05.
13. apps   — memtier.spec.H100's rates against this run's
             launch/calibrate.py, then the driver twins on the card: (a)
             quickstart, its counters
             equal to the same twin's with --device cpu but for the small
             mm's two host slices the card streams, 8 gemm.cu launches;
             (b) must_lsms at n 6912, complex128, atoms 2, energies 2,
             scf 1 under cpu, memcopy, counter and dfu, each its own
             session with sync on: energies within 1e-9, residuals, and
             every zgemm counter as core/policy.py's rules give it
             (lsms_expected), 64 gemm.cu launches; the live dfu trace
             replayed through memtier.spec.H100 against the live zgemm
             seconds, within REPLAY_BAND; (c) parsec_dft at ngrid 8192,
             nstates 256, 12 filter passes under dfu: Ritz error < 1e-6,
             0 B moved, one gemm.cu launch per dgemm; (d) serve_offload
             on mamba2-1.3b at full width and depth with a float32 cache:
             tokens bit for bit across dfu, memcopy and pinned, each
             policy's bytes, migrations and reuses, 97 gemm.cu launches
             per forward, 30 replays per Server, the tokens bit for bit
             the eager step's, the captured step's checks as in 8; (e)
             train_100m at its widths (8 x 256, n_micro
             2, remat dots), its own 300 steps with a checkpoint every
             100: first
             its first step's loss and gradients through the kernels
             against the plain step at float32 tolerances, with the
             transposed-dB control, and gemm.cu's and flash's FMA paths
             at the model's shapes; then the twin's main: 3 gemm.cu
             launches per product per microbatch, flash twice per layer
             per microbatch all on the FMA path, 299 replays of the
             captured step, a finite falling loss, checkpoints 100, 200,
             300, the last restored bit for bit; the replayed step's
             checks as in 11.  Meanwhile CPU processes replay
             the LSMS and PARSEC production traces on the GH200 and H100
             models; their tables print at the end.

The kernels line's launches are those of the main path's runs: the
BLAS, LSMS and solvers phases, the venue phase's (a)-(c), every run of
the runtime phase, the serve phase's dfu, streams and memcopy runs, the
serve_moe_ssm and serve_encdec_vlm phases' dfu and memcopy runs, the
train phase's two fits, the mesh phase's (a) and (f) runs, and the apps
phase's card runs of its five twins (quickstart, must_lsms's four policies,
parsec_dft, serve_offload's three policies, train_100m's fit), each with
the counts set to 0 just before it.
The eager checks', the replay checks', the cross-checks', the mesh
phase's scatter comparison, the profiles',
the gradient checks', the restart's, the remat steps', the plain and
witness fits', the apps phase's kernel checks' and its CPU quickstart's
launches are not among them.  Every mismatch or missing
launch raises, so the script exits non-zero.
The lines before the last are a JSON object of per-kernel numbers and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the port
beside it, the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
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
#: right-hand sides that take trsm's wide path: 133 panels of 128
TRSM_WIDE_N = 132 * 128 + 37
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


def gemm_times(a, b, label: str, phase: str = "kernels",
               card: str = "") -> dict:
    """Kernel, plain-version and torch.matmul times of one product (a
    batch of them for 3-D operands, where torch.matmul is torch.bmm), with
    its bound: 2*M*N*K operations per matrix, and each operand read once
    and the result written once.  ``card`` ends the logged line."""
    import torch
    from repro_torch.kernels import gemm
    batch = a.shape[0] if a.dim() == 3 else 1
    (m, k), n = a.shape[-2:], b.shape[-1]
    dt = str(a.dtype)[6:]
    ms = time_ms(lambda: gemm.gemm(a, b), reps=5)
    plain_ms = time_ms(lambda: gemm.gemm_plain(a, b), reps=5)
    lib_ms = time_ms(lambda: torch.matmul(a, b), reps=5)
    flops = 2.0 * batch * m * n * k
    bms, by = bound(flops, a.element_size() * batch
                    * (m * k + k * n + m * n), dt)
    log(phase, f"gemm {dt} {label}: kernel {ms:.3f} ms "
               f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
               f"torch.{'bmm' if batch > 1 else 'matmul'} {lib_ms:.3f} ms, "
               f"bound {bms:.4f} ms ({by})" + (f"; {card}" if card else ""))
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
    once.  The plain version is the dataflow path's block-row order
    (trsm_dataflow_plain); each timed kernel call is one launch after
    one memset of its flags (the dataflow path) or the wide path's two
    launches, as trsm.plan picks."""
    from repro_torch.kernels import ref, trsm
    mt = a.shape[-1]
    r = b.numel() // mt
    p = trsm.plan(mt, r, 1)
    ms = time_ms(lambda: trsm.trsm(a, b, **kw), reps=5)
    plain_ms = time_ms(lambda: trsm.trsm_dataflow_plain(a, b, **kw),
                       reps=plain_reps)
    lib_ms = time_ms(lambda: ref.trsm(a, b, **kw), reps=5)
    bms, by = bound(float(mt) * mt * r,
                    a.element_size() * (mt * (mt + 1) / 2 + 2 * mt * r),
                    str(a.dtype)[6:])
    path = "wide path, two launches" if p.wide else "one launch"
    log("kernels", f"trsm {str(a.dtype)[6:]} {label}: kernel {ms:.3f} ms "
                   f"({p.blocks} blocks, {path}), "
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
    """One solve on the kernel, on the path trsm.plan picks for its
    canonical shape: the dataflow path's one launch after one memset of
    its flags, or the wide path's two launches (counted on
    trsm.wide_launches) and no memset."""
    from repro_torch.kernels import trsm
    m = a.shape[-1]
    n = b.shape[-1] if kw.get("side", "L") == "L" else b.shape[-2]
    wide = trsm.plan(m, n, b.numel() // (m * n)).wide
    before = (trsm.launches, trsm.memsets, trsm.wide_launches)
    got = trsm.trsm(a, b, **kw)
    moved = tuple(x - y for x, y in zip(
        (trsm.launches, trsm.memsets, trsm.wide_launches), before))
    want = (2, 0, 1) if wide else (1, 1, 0)
    if moved != want:
        raise AssertionError(f"trsm {name}: (launches, memsets, "
                             f"wide_launches) moved {moved}, want {want}")
    return got


def phase_kernels_trsm(dev, gen) -> dict:
    """trsm against the dataflow path's block-row order
    (trsm_dataflow_plain): every variant (side x uplo x trans N/T/C x
    diag) in both types at m = 300, n = 40 (five block rows, two panels)
    and at m = 1, 63, 64, 65, and on the wide path at m = 200, 300 with
    TRSM_WIDE_N right-hand sides; a batched solve on each path; an LU
    factor's unit-lower triangle against solve_triangular; then the BLAS
    phase's 6912 x 32 solve, timed."""
    import torch
    from repro_torch.kernels import trsm

    def rnd(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen,
                           dtype=torch.float64).to(dtype).to(dev)
    # the dataflow path, then the wide path: 133 panels of 128 (the last
    # ragged) at m 200 (a second block row of 64 + 8 rows) and 300 (its
    # last block row one diagonal block), and 3 problems of 44 panels
    paths = (("dataflow path", (300, 1, 63, 64, 65), 40, (300, 40),
              "one launch"),
             ("wide path", (200, 300), TRSM_WIDE_N, (130, 44 * 128 - 5),
              "two launches"))
    for dt in (torch.float32, torch.float64):
        tol = TRSM_TOL[str(dt)[6:]]
        for path, ms, n, (bm, bn), launches in paths:
            worst, cases = 0.0, 0
            for m in ms:
                for side in "LR":
                    for uplo in "LU":
                        for tr in "NTC":
                            for dg in "NU":
                                a = tri(gen, m, uplo, dt, dev)
                                b = (rnd(m, n, dtype=dt) if side == "L"
                                     else rnd(n, m, dtype=dt))
                                kw = dict(side=side, uplo=uplo, trans=tr,
                                          diag=dg)
                                got = trsm_one(a, b, f"{dt} {path} m={m} {kw}",
                                               **kw)
                                want = trsm.trsm_dataflow_plain(a, b, **kw)
                                _, rel = rel_err(got, want)
                                if not rel <= tol:
                                    raise AssertionError(
                                        f"trsm {dt} {path} m={m} {kw}: rel "
                                        f"err {rel:.3e} > {tol:g}")
                                worst, cases = max(worst, rel), cases + 1
            a = torch.stack([tri(gen, bm, "L", dt, dev) for _ in range(3)])
            b = rnd(3, bm, bn, dtype=dt)
            got = trsm_one(a, b, f"{dt} {path} batched 3 x {bm} x {bn}",
                           trans="T")
            _, rel = rel_err(got, trsm.trsm_dataflow_plain(a, b, trans="T"))
            if not rel <= tol:
                raise AssertionError(f"trsm {dt} {path} batched: rel err "
                                     f"{rel:.3e}")
            log("kernels", f"trsm {str(dt)[6:]} {path}: {cases} solves (24 "
                           f"variants at m = {ms}, n = {n}) and a batched "
                           f"one, {launches} each, worst rel err "
                           f"{max(worst, rel):.3e} vs the dataflow path's "
                           f"plain order (tol {tol:g})")
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


def gemm_parsec_check(a, psi) -> None:
    """PARSEC's own product S_blk = Hpsi_blk^T Psi on gemm.cu, A the
    ``h.mT`` view as the application passes it: path 5 (float64, M < 64:
    DMMA on the block's 32 rows, K split across blocks), one launch on the
    path's counter and one reduction, against the plain version, two calls
    bit for bit, and its times beside torch.matmul and its bound (the
    bytes of Psi, 0.5434 ms)."""
    import torch
    from repro_torch.kernels import gemm
    (m, k), n = a.shape, psi.shape[1]
    p = gemm.plan(a, psi)
    if p.path != gemm.SKINNY_F64 or p.splits < 2:
        raise AssertionError(f"gemm float64 {m}x{n}x{k}: plan {p}, want "
                             f"path {gemm.SKINNY_F64} with K split")
    before = (gemm.launches, gemm.skinny_f64_launches, gemm.reduce_launches)
    got = gemm.gemm(a, psi)
    moved = tuple(x - y for x, y in zip(
        (gemm.launches, gemm.skinny_f64_launches, gemm.reduce_launches),
        before))
    if moved != (1, 1, 1):
        raise AssertionError(f"gemm float64 {m}x{n}x{k}: counters moved "
                             f"{moved} (launches, skinny_f64_launches, "
                             f"reduce_launches), want (1, 1, 1)")
    label = (f"{m}x{n}x{k} (PARSEC's projection, A = h.mT; path 5, K split "
             f"{p.splits}, {-(-n // gemm.SKINNY_F64_COLS) * p.splits} "
             f"blocks)")
    check(f"gemm float64 {label}", got, gemm.gemm_plain(a, psi),
          TOL["float64"])
    if not torch.equal(gemm.gemm(a, psi), got):
        raise AssertionError(f"gemm float64 {m}x{n}x{k}: two calls differ")
    log("kernels", f"gemm float64 {m}x{n}x{k}: two calls bit for bit")
    gemm_times(a, psi, label)


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


def trsm_chefsi(psi, gen, dev) -> None:
    """CheFSI's Psi R^-1 (portbench's chefsi.resident) at PARSEC's shape,
    side R upper: the wide path against the dataflow path's plain order
    within TRSM_TOL and against the library's solve_triangular, timed
    beside both."""
    import torch
    from repro_torch.kernels import ref, trsm
    r = tri(gen, psi.shape[-1], "U", torch.float64, dev)
    kw = dict(side="R", uplo="U")
    label = f"{psi.shape[0]}x{psi.shape[1]} side R upper (CheFSI's Psi R^-1)"
    got = trsm_one(r, psi, label, **kw)
    check(f"trsm float64 {label}", got,
          trsm.trsm_dataflow_plain(r, psi, **kw), TRSM_TOL["float64"])
    check(f"trsm float64 {label} vs solve_triangular", got,
          ref.trsm(r, psi, **kw), TRSM_TOL["float64"])
    del got
    trsm_times(r, psi, label, plain_reps=1, **kw)


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
    trsm_chefsi(psi, gen, dev)
    # the split passes: S_blk = Hpsi_blk^T Psi, M=32, N=2400, K=93536
    blk = torch.randn(NGRID, NBLOCK, generator=dgen, dtype=torch.float64,
                      device=dev)
    a = blk.mT
    gemm_parsec_check(a, psi)
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


def flash_bound(logits: int, d: int, nbytes: float, softcap: bool,
                dtype: str = "bfloat16") -> tuple:
    """The least time of a flash call: the larger of its matrix operations
    (4 d per live logit) at the bf16 tensor-core peak (at the float32 FMA
    peak for ``dtype="float32"``, the FMA path), its special-function
    operations (ex2 and rcp of the soft-cap's tanh and ex2 of the softmax:
    3 per live logit, 1 without the cap) at PEAK_MUFU, and its bytes (q, k,
    v read once, the output written once).  Returns (ms, bound_by, which
    term binds)."""
    kind = "FMA" if dtype == "float32" else "tensor-core"
    terms = {
        f"{kind} operations": 4.0 * d * logits / PEAK_OPS[dtype],
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
    the unblocked panels inside it (``repro_torch.core.lapack.
    _factor_panel``: a capture and its replay, or a replay), each
    synchronized before and after, with the bytes the session moved
    during the span and the panels captured.  ``first`` keeps the first
    arguments of each routine, for the library yardstick on the same
    inputs."""

    DRIVERS = ("getrf", "getrs", "gesv", "potrf", "potrs", "syev")

    def __init__(self, stats):
        self.stats = stats
        self.spans = []          # (span id, wall s, panels s, moved B)
        self.captured = {}       # span id -> panels captured in it
        self.first = {}
        self._panel_s = 0.0
        self._saved = []

    def __enter__(self):
        import torch
        from repro_torch.core import lapack
        from repro_torch.solvers import drivers
        panel = lapack._factor_panel

        def timed_panel(p):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = panel(p)       # ends with the pivots' copy to the host
            self._panel_s += time.perf_counter() - t0
            return out
        self._saved = [(lapack, "_factor_panel", panel)]
        lapack._factor_panel = timed_panel
        for name in self.DRIVERS:
            fn = getattr(drivers, name)
            self._saved.append((drivers, name, fn))
            setattr(drivers, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        import torch

        from repro_torch.core import lapack

        def timed(*args, **kw):
            self.first.setdefault(name, args)
            torch.cuda.synchronize()
            moved0 = self.stats.total_moved_bytes
            captures0 = lapack.captures
            self._panel_s = 0.0
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            sid = f"{name}#{len(self.spans)}"
            self.spans.append((sid, time.perf_counter() - t0,
                               self._panel_s,
                               self.stats.total_moved_bytes - moved0))
            self.captured[sid] = lapack.captures - captures0
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
    from repro_torch.core import lapack
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
    # every panel shape of (a) is captured in (a)'s first getrf
    lapack.release_graphs()
    lapack.reset_launches()
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
        # the first getrf captures each panel shape and replays it, every
        # later getrf of the shape replays them all
        # (panel heights padded to lapack.BUCKETS per group)
        getrfs = [sid for sid, _, _, _ in clock.spans
                  if sid.startswith("getrf")]
        captured = [clock.captured[sid] for sid in getrfs]
        graphs = len(lapack._GRAPHS._groups[
            (SOLVER_NB, torch.complex128, dev)].graphs)
        if (lapack.captures, lapack.replays) != (graphs, want * panels) \
                or captured != [graphs] + [0] * (want - 1) \
                or graphs > lapack.BUCKETS:
            raise AssertionError(f"solvers (a): panel graphs captured "
                                 f"{lapack.captures} ({captured} per "
                                 f"getrf, {graphs} held), replayed "
                                 f"{lapack.replays}; want at most "
                                 f"{lapack.BUCKETS} in the first getrf "
                                 f"and {want * panels} replays")
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
                how = (f"captures {clock.captured[sid]} panel graphs, "
                       f"replays {panels}" if clock.captured[sid]
                       else f"replays {panels}")
                log("solvers", f"(a) {sid} ({how}): {w:.3f} s = panels "
                               f"{p:.3f} + "
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
    lu_factor_native = wall_s(lambda: torch.linalg.lu_factor(m_first))
    getrf_w = [wl for sid, wl, _, _ in clock.spans[:n_a]
               if sid.startswith("getrf")]
    getrf_p = [p for sid, _, p, _ in clock.spans[:n_a]
               if sid.startswith("getrf")]
    getrs_w = [wl for sid, wl, _, _ in clock.spans if sid.startswith("getrs")]
    log("solvers", f"(a) LU of M ({n}, complex128): the tier's getrf "
                   f"{np.mean(getrf_w):.3f} s + getrs {np.mean(getrs_w):.3f} "
                   f"s per solve (mean of {len(getrf_w)}); cuSOLVER "
                   f"lu_factor + lu_solve {lu_native:.3f} s, lu_factor "
                   f"{lu_factor_native:.3f} s")
    log("solvers", f"(a) getrf: the first (captures "
                   f"{captured[0]} panel graphs for its "
                   f"{panels} panels) "
                   f"{getrf_w[0]:.3f} s, panels {getrf_p[0]:.3f} s; the "
                   f"{len(getrf_w) - 1} replayed "
                   f"{min(getrf_w[1:]):.3f}-{max(getrf_w[1:]):.3f} s (mean "
                   f"{np.mean(getrf_w[1:]):.3f}), panels "
                   f"{min(getrf_p[1:]):.3f}-{max(getrf_p[1:]):.3f} s; "
                   f"cuSOLVER lu_factor {lu_factor_native:.3f} s; {card_line()}")
    # one replayed panel against the column loop run eagerly, on M's
    # first panel; the session's close freed its graphs: capture the
    # panel's bucket again first
    lapack._factor_panel(m_first[:, :SOLVER_NB].clone())
    p_graph = m_first[:, :SOLVER_NB].clone()
    p_eager = p_graph.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    piv_graph = lapack._factor_panel(p_graph)
    t_replay = time.perf_counter() - t0
    piv_eager = torch.empty(SOLVER_NB, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lapack._pivot_panel(p_eager, piv_eager)
    piv_eager = piv_eager.tolist()
    t_eager = time.perf_counter() - t0
    if piv_graph != piv_eager or not torch.equal(p_graph, p_eager):
        raise AssertionError(f"solvers (a): a replayed {n} x {SOLVER_NB} "
                             f"panel differs from the eager column loop's "
                             f"(max |diff| "
                             f"{(p_graph - p_eager).abs().max().item():.3e})")
    log("solvers", f"(a) M's first panel ({n} x {SOLVER_NB}, complex128): "
                   f"one replay {t_replay * 1e3:.2f} ms, the column loop "
                   f"from Python {t_eager * 1e3:.2f} ms; factors and pivots "
                   f"bit for bit")
    del p_graph, p_eager
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


def serve_run(model, params, policy: str, n: int, prompt, dev,
              max_len: int = SERVE_LEN, extra=None, start=None,
              cache_dtype=None):
    """``n`` tokens through the serving loop as a user runs it: a Server
    under ``policy``, ``prefill`` (with the family's ``extra`` inputs),
    then ``decode`` of n - 1 tokens from ``start`` (default the prompt's
    length, as ``generate``), whose steps on the card are the warm-up and
    then replays of one captured graph.  Returns (server, tokens (B, n),
    the position after the last step)."""
    import torch
    from repro_torch.configs.base import torch_dtype
    from repro_torch.train import Server, ServeConfig
    srv = Server(model, params, ServeConfig(
        max_len=max_len, offload_policy=policy,
        cache_dtype=cache_dtype or torch_dtype(model.cfg.dtype)),
        device=dev)
    start = prompt.shape[1] if start is None else start
    tok, cache = srv.prefill(prompt, extra)
    gen, cache = srv.decode(tok, cache, start, n - 1)
    del cache
    return srv, torch.cat([tok, gen], dim=1), start + n - 1


def eager_run(model, params, n: int, prompt, dev, max_len: int = SERVE_LEN,
              extra=None, start=None, cache_dtype=None):
    """The same ``n`` tokens with the step run from Python: a dfu Server's
    ``prefill``, then n - 1 calls of ``Server._decode_step`` at host
    positions (the step the graph captures, uncaptured), keeping the
    last-position logits of every forward.  Returns (tokens (B, n), the
    logits (B, n, vocab))."""
    import torch
    from repro_torch.configs.base import torch_dtype
    from repro_torch.train import Server, ServeConfig
    forward, kept = model.forward, []

    def keeping(params_, tokens, **kw):
        logits, aux, cache = forward(params_, tokens, **kw)
        kept.append(logits[:, -1].clone())
        return logits, aux, cache

    model.forward = keeping
    try:
        srv = Server(model, params, ServeConfig(
            max_len=max_len, offload_policy="dfu",
            cache_dtype=cache_dtype or torch_dtype(model.cfg.dtype)),
            device=dev)
        start = prompt.shape[1] if start is None else start
        tok, cache = srv.prefill(prompt, extra)
        outs = [tok]
        with torch.no_grad():
            for i in range(n - 1):
                tok, cache = srv._decode_step(tok, cache, start + i)
                outs.append(tok)
        del cache
    finally:
        model.forward = forward
    return torch.cat(outs, dim=1), torch.stack(kept, dim=1)


#: profiler kernel names (demangled) of the decode step's kernels, by the
#: counter that counts their launches
STEP_KERNELS = {
    "gemm": r"\b(tc|skinny_dot|skinny_strip|dmma_f64|simt_f32|skinny_dmma)"
            r"_kernel\b",
    "gemm_reduce": r"\bsplitk_reduce(_f64)?_kernel\b",
    "flash_attention": r"\bflash(_wgmma)?_kernel\b",
    "decode_attention": r"\bdecode_kernel\b",
}


def record_counts(record) -> dict:
    """The launches one replay counts, by STEP_KERNELS' names, from a
    capture's record (``kernels.compat.recording``)."""
    from repro_torch.kernels import attention, decode_attention, gemm
    where = {id(vars(gemm)): {"launches": "gemm",
                              "reduce_launches": "gemm_reduce"},
             id(vars(attention)): {"launches": "flash_attention"},
             id(vars(decode_attention)): {"launches": "decode_attention"}}
    out = dict.fromkeys(STEP_KERNELS, 0)
    for counters, moves in record:
        for name, n in moves.items():
            key = where.get(id(counters), {}).get(name)
            if key is not None:
                out[key] += n
    return out


#: the profiled replay's mark (a record_function range), and the idle
#: gap before it that sets its device events apart from the replay
#: before, whatever the skew between the trace's host and device clocks
REPLAY_MARK, MARK_GAP_S = "chip_smoke.replay", 0.005


def marked_events(prof) -> list:
    """device_events of the kernels, copies and memsets that started
    after the REPLAY_MARK range opened, less half of MARK_GAP_S (the
    mark's own device-side annotation left out)."""
    from torch.autograd import DeviceType
    mark = next(e for e in prof.events()
                if e.name == REPLAY_MARK and e.device_type == DeviceType.CPU)
    after = mark.time_range.start - MARK_GAP_S * 1e6 / 2
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name != REPLAY_MARK
            and e.time_range.start >= after]


def measure_replays(replay, eager, record, where: str, phase: str,
                    reps: int = 5) -> dict:
    """A captured step, after its run: one more ``replay()`` under
    ``set_sync_debug_mode("error")`` (a replay makes no host sync); two
    replays under torch.profiler, the second's kernels (marked_events)
    counted by name against the capture's ``record`` (the counters'
    amounts per replay), its wall, device time and idle share; then
    ``reps`` replays by the host clock, and ``reps`` ``eager()`` steps
    (the same step run from Python on the same buffers) beside them.
    These steps are not the main path's launches.  Returns the replayed
    step's wall ms (unprofiled), the wall under the profiler, device ms,
    idle share, the kernels seen, and the eager step's wall ms."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    want = record_counts(record)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a trace can miss the kernels at its very start: the first
            # replay only opens the window, the marked one is counted
            replay()
            torch.cuda.synchronize()
            time.sleep(MARK_GAP_S)
            with record_function(REPLAY_MARK):
                t0 = time.perf_counter()
                replay()
                torch.cuda.synchronize()
                prof_wall = (time.perf_counter() - t0) * 1e3
        events = marked_events(prof)
        seen = {name: sum(1 for ev, _ in events if re.search(rx, ev))
                for name, rx in STEP_KERNELS.items()}
        if seen == want:
            break
        # fewer kernels than the record is taken again in a fresh
        # profile (the card's profiler once recorded no event at all,
        # device_ms); more is never the profiler's doing
        other = {}
        for ev, _ in events:
            if not any(re.search(rx, ev) for rx in STEP_KERNELS.values()):
                other[ev[:60]] = other.get(ev[:60], 0) + 1
        if attempt == PROFILE_TRIES or any(seen[k] > want[k] for k in want):
            raise AssertionError(f"{where}: a profiled replay ran {seen} "
                                 f"kernels, the capture's record counts "
                                 f"{want}; its other device events {other}")
        log(phase, f"{where}: profile try {attempt} recorded {seen} "
                   f"kernels of the record's {want} (other device events "
                   f"{other}); profiled again")
    dev_ms = sum(us for _, us in events) / 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        replay()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        eager()
    torch.cuda.synchronize()
    return dict(wall=wall, prof_wall=prof_wall, device=dev_ms,
                idle=max(0.0, 1 - dev_ms / wall), seen=seen,
                eager=(time.perf_counter() - t0) * 1e3 / reps)


def replay_checks(srv, tok, pos: int, where: str, phase: str,
                  reps: int = 5) -> dict:
    """A Server whose decode step is captured, after its run: the replay
    at ``pos`` measured and checked by measure_replays against the eager
    step, ``Server._decode_step`` at the host position on the same
    buffers.  Returns the replayed step's wall ms (unprofiled), device
    ms and idle share, and the eager step's wall ms."""
    import torch
    g = srv.graphed
    if g.graph is None:
        raise AssertionError(f"{where}: the Server captured no step")
    tok, cache = tok.to(srv.device), g.args[1]

    def eager():
        with torch.no_grad():
            srv._decode_step(tok, cache, pos)

    t = measure_replays(lambda: srv._step(tok, cache, pos), eager,
                        g.record, where, phase, reps)
    log(phase, f"{where}: replayed decode step: wall {t['wall']:.2f} ms "
               f"(mean of {reps}; {t['prof_wall']:.2f} under the "
               f"profiler), device {t['device']:.2f} ms, idle share "
               f"{t['idle']:.3f}; the eager step on the same buffers "
               f"{t['eager']:.2f} ms (mean of {reps}); no host sync in a "
               f"replay; its kernels by name {t['seen']} = the capture's "
               f"record per replay; {srv.replays} replays in all, 1 "
               f"capture")
    return {k: t[k] for k in ("wall", "device", "idle", "eager")}


def cross_check(model, params, prompt, out, cached, dev,
                where: str = "serve cross-check", extra=None) -> dict:
    """A forward without a cache (the flash kernel on every layer) over
    the prompt and all but the last generated token, against the cached
    steps' logits (the decode kernel on global layers, plain attention on
    local ones).  Greedy tokens must agree wherever the cached top-2
    margin exceeds 2 max|dlogit|: a flip needs the leader to drop and the
    runner-up to rise, each by at most max|dlogit|.  ``extra`` (a VLM's
    patches) goes to the forward too."""
    import torch
    seq = torch.cat([prompt.to(dev), out[:, :-1]], dim=1)
    with torch.no_grad():
        logits, _, _ = model.forward(params, seq, **(extra or {}))
    nocache = logits[:, prompt.shape[1] - 1:]
    del logits
    if not bool(torch.isfinite(nocache).all() & torch.isfinite(cached).all()):
        raise AssertionError(f"{where}: non-finite logits")
    delta = (nocache - cached).abs().max().item()
    top2 = cached.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * delta
    agree = nocache.argmax(-1) == out
    if not bool(agree[sure].all()):
        raise AssertionError(f"{where}: tokens differ at steps with margin "
                             f"> 2 x {delta:.4f}")
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


def device_profile(fn, label: str, top: int = 6, phase: str = "serve",
                   host: bool = False) -> None:
    """Run ``fn`` once under torch.profiler: wall time, device time summed
    over kernels and copies, the device's idle share, and the kernels that
    take the most device time; with ``host``, also the operators that
    take the most host time (self CPU time, the profiler's own cost
    included).  Returns the device time in ms (None where the profiler
    recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the wall of the call alone: the profiler's start and its trace
        # processing at exit stay outside it
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for name, us in device_events(prof):
        count, total = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, total + us)
    if not by_name:
        ms = time_ms(fn, reps=1)
        log(phase, f"profile {label}: the profiler recorded no device "
                   f"time; {ms:.1f} ms by CUDA events")
        return None
    total_ms = sum(t for _, t in by_name.values()) / 1e3
    log(phase, f"profile {label}: wall {wall_ms:.1f} ms (under the "
               f"profiler), device {total_ms:.1f} ms, idle share "
               f"{max(0.0, 1 - total_ms / wall_ms):.3f}")
    for name, (count, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
        log(phase, f"  {us / 1e3:9.2f} ms  {count:5d} x  {name[:90]}")
    if host:
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        for e in ops[:top]:
            log(phase, f"  host {e.self_cpu_time_total / 1e3:9.2f} ms  "
                       f"{e.count:5d} x  {e.key[:80]}")
    return total_ms


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
    from repro_torch.kernels import attention, compat
    from repro_torch.launch.serve import serve_streams
    from repro_torch.train import ServeConfig
    pool = SharedDevicePool(STREAMS * SERVE_CACHE_BYTES + (1 << 30),
                            name="serve")
    # each stream's Server captures its own step, in its own thread
    real_capture, captured = compat.capture, []

    def capture(*args, **kw):
        out = real_capture(*args, **kw)
        captured.append(threading.current_thread().name)
        return out

    compat.capture = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        results = serve_streams(model, params, ServeConfig(
            max_len=SERVE_LEN, offload_policy="dfu"), prompt, STREAM_GEN,
            STREAMS, pool, device=dev)
    finally:
        compat.capture = real_capture
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(set(captured)) != STREAMS or len(captured) != STREAMS:
        raise AssertionError(f"serve streams: captures in threads "
                             f"{captured}, want one in each of {STREAMS}")
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
                 f"(the cache charges no pool); each stream captured its "
                 f"step in its own thread ({captured})")
    for line in pool.report().splitlines():
        log("serve", f"(d) {line}")
    return got


def phase_serve(dev) -> dict:
    """gemma2-9b at full width through the serving loop: dfu, then
    memcopy with every attention kernel call held to its plain version
    (serve_policies), then launch/serve.py's streams path (these runs are
    the main path, and their launches are returned), then the
    cross-check between the cached steps and a forward without a cache
    over two layers, then a device profile of one prefill and one decode
    step."""
    import dataclasses
    import torch
    from repro_torch.models import get_config
    cfg = dataclasses.replace(get_config("gemma2_9b"), prefill_fresh_kv=True)
    model, params = serve_model(cfg, dev, "serve")
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator().manual_seed(1))
    # q, k, v, o, gate, up, down per layer, and the tied vocab head
    assert gemms_per_forward(cfg) == 7 * cfg.n_layers + 1 == 295
    launched, out, st = serve_policies(
        model, params, prompt, n_dfu=SERVE_GEN, n_memcopy=4,
        max_len=SERVE_LEN, want_bytes=SERVE_CACHE_BYTES, dev=dev,
        where="gemma2-9b", phase="serve")
    for name, n in serve_streams_check(model, params, prompt, out, st,
                                       cfg.n_layers, dev).items():
        launched[name] = launched.get(name, 0) + n
    serve_cross_check(cfg, prompt, SERVE_GEN, dev, "serve cross-check",
                      "serve")
    MEASURED["gemma2-9b prefill"] = serve_profile(
        model, params, prompt, SERVE_LEN, dev, "gemma2-9b", "serve")
    del params
    torch.cuda.empty_cache()
    return launched


#: the serve_moe_ssm phase: batch, prompt, tokens generated under dfu and
#: under memcopy, for granite-moe-1b-a400m and mamba2-1.3b at full width
#: and depth (the prompt is 64 SSD chunks of 64)
MS_BATCH, MS_PROMPT, MS_GEN, MS_MEMCOPY_GEN = 2, 4096, 16, 4
MS_LEN = MS_PROMPT + MS_GEN
#: granite's decode cache: 24 layers x (k, v), each (batch, 8 KV heads,
#: MS_LEN slots, head size 64) in bf16
GRANITE_CACHE_BYTES = 24 * 2 * MS_BATCH * 8 * MS_LEN * 64 * 2
assert GRANITE_CACHE_BYTES == 404_226_048
#: mamba2's decode state: 48 layers x (ssm_h float32 (batch, 64 heads,
#: state 128, head size 64), conv_state bf16 (batch, 3, 4096 + 2 x 128));
#: no term in MS_LEN: the state is O(1) in context
MAMBA_STATE_BYTES = 48 * (MS_BATCH * 64 * 128 * 64 * 4
                          + MS_BATCH * 3 * (4096 + 2 * 128) * 2)
assert MAMBA_STATE_BYTES == 201_326_592 + 2_506_752 == 203_833_344
#: moonshot-v1-16b-a3b at full width, depth cut 48 -> 12 (15.0 GB of bf16
#: weights; all 48 would hold ~56 GB): batch 2 x 2048, dfu only
MOONSHOT_LAYERS, MOONSHOT_PROMPT, MOONSHOT_GEN = 12, 2048, 8
#: jamba-1.5-large-398b reduced (one 8-layer period: 7 SSD + 1 attention
#: layer, MoE at odd positions, float32): batch 2 x 64, dfu only
JAMBA_PROMPT, JAMBA_GEN = 64, 8
#: mamba2's cross-check generates 65 tokens: a forward without a cache
#: over the prompt and all but the last generated token must be a whole
#: number of SSD chunks, 4096 + 64 = 65 chunks
MAMBA_CROSS_GEN = 65


def state_bytes(cfg, batch: int, max_len: int, itemsize: int) -> int:
    """The decode state's bytes, from the config alone: (k, v) of
    ``max_len`` slots per attention layer, float32 ssm_h and conv_state
    per SSD layer; ``itemsize`` is the cache dtype's."""
    total = 0
    for i in range(cfg.n_layers):
        if cfg.is_attn_layer(i):
            total += 2 * batch * cfg.n_kv_heads * max_len * cfg.head_dim \
                * itemsize
        else:
            total += batch * cfg.ssm_heads * cfg.ssm_state \
                * cfg.ssm_head_dim * 4 + batch * (cfg.ssm_conv - 1) \
                * (cfg.d_inner + 2 * cfg.ssm_state) * itemsize
    return total


def gemms_per_forward(cfg) -> int:
    """gemm.cu launches of one forward: q, k, v, o per attention layer;
    in_proj, out_proj per SSD layer; the router and the three batched
    expert products per MoE layer; gate, up, down per MLP of nonzero
    width; the vocab head."""
    n = 1
    for i in range(cfg.n_layers):
        n += 4 if cfg.is_attn_layer(i) else 2
        if cfg.is_moe_layer(i):
            n += 4
        elif cfg.d_ff:          # mamba2's MLP has width 0: no product
            n += 3
    return n


def moe_ssm_kernel_checks(dev) -> None:
    """The kernels at the shapes this phase gives them, each against its
    plain version, with kernel, plain, library and bound times: gemm.cu on
    granite's batched expert products (32 x (2560 x 1024 -> 512) at
    prefill on path 1, 32 x (8 x 1024 -> 512) at decode on path 2, against
    torch.bmm), its router, its vocab head at the ragged N 49155 over the
    table's transposed view, and mamba2's in_proj and out_proj;
    decode_attention.cu at granite's [2,16,1,64] / [2,8,S,64] and
    moonshot's [2,16,1,128] / [2,16,S,128]; flash_attention.cu at their
    prefill shapes, on the wgmma path."""
    import torch
    from repro_torch.kernels import attention, decode_attention, gemm
    gen = torch.Generator(device=dev).manual_seed(19)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    n_pre, cap = MS_BATCH * MS_PROMPT, 2560    # granite's prefill capacity
    table = rnd(49155, 1024)
    cases = [
        (f"granite experts 32x({cap}x1024->512) prefill",
         rnd(32, cap, 1024), rnd(32, 1024, 512), gemm.TC),
        ("granite experts 32x(8x1024->512) decode", rnd(32, 8, 1024),
         rnd(32, 1024, 512), gemm.SKINNY),
        (f"granite expert down 32x({cap}x512->1024) prefill",
         rnd(32, cap, 512), rnd(32, 512, 1024), gemm.TC),
        (f"granite router {n_pre}x32x1024", rnd(n_pre, 1024),
         rnd(1024, 32), gemm.TC),
        (f"granite vocab head {n_pre}x49155x1024 (table.mT)",
         rnd(n_pre, 1024), table.mT, gemm.TC),
        (f"granite vocab head {MS_BATCH}x49155x1024 (table.mT)",
         rnd(MS_BATCH, 1024), table.mT, gemm.SKINNY),
        (f"mamba2 in_proj {n_pre}x8512x2048", rnd(n_pre, 2048),
         rnd(2048, 8512), gemm.TC),
        (f"mamba2 in_proj {MS_BATCH}x8512x2048", rnd(MS_BATCH, 2048),
         rnd(2048, 8512), gemm.SKINNY),
        (f"mamba2 out_proj {n_pre}x2048x4096", rnd(n_pre, 4096),
         rnd(4096, 2048), gemm.TC),
    ]
    for label, a, b, path in cases:
        p = gemm.plan(a, b)
        if p.path != path:
            raise AssertionError(f"gemm {label}: path {p.path}, want {path}")
        label = f"{label}, path {p.path}, splits {p.splits}"
        check(f"gemm bfloat16 {label}", gemm.gemm(a, b),
              gemm.gemm_plain(a, b), TOL["bfloat16"])
        gemm_times(a, b, label, phase="serve_moe_ssm")
    del cases, table
    # attention at granite's (D 64, 2 query heads per KV head) and
    # moonshot's (D 128, MHA) shapes; no softcap in either model
    for name, hq, hkv, t, d in (("granite", 16, 8, MS_PROMPT, 64),
                                ("moonshot", 16, 16, MOONSHOT_PROMPT, 128)):
        b = MS_BATCH
        q, k, v = rnd(b, hq, t, d) * ATTN_Q_SCALE, rnd(b, hkv, t, d), \
            rnd(b, hkv, t, d)
        before = attention.launches_by_path[attention.WGMMA]
        got = attention.flash_attention(q, k, v, causal=True)
        if attention.launches_by_path[attention.WGMMA] != before + 1:
            raise AssertionError(f"flash_attention {name}: not on the "
                                 f"wgmma path")
        label = f"flash_attention bf16 {name} [{b},{hq},{t},{d}] / " \
                f"[{b},{hkv},{t},{d}] causal (wgmma path)"
        check_rows(label, got, attention.flash_attention_plain(
            q, k, v, causal=True), ATTN_TOL)
        ms = time_ms(lambda: attention.flash_attention(q, k, v, causal=True),
                     reps=5)
        plain_ms = time_ms(lambda: attention.flash_attention_plain(
            q, k, v, causal=True), reps=2)
        lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True), reps=5)
        pairs = causal_pairs(t, 0)
        bms, _, term = flash_bound(b * hq * pairs, d, 2 * (
            2 * b * hq * t * d + 2 * b * hkv * t * d), softcap=False)
        log("serve_moe_ssm", f"{label}: kernel {ms:.3f} ms, plain "
                             f"{plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, "
                             f"bound {bms:.4f} ms ({term})")
        del q, k, v, got
        s_len = t + (MS_GEN if name == "granite" else MOONSHOT_GEN)
        kv_len = t + 1
        q, k, v = rnd(b, hq, 1, d) * ATTN_Q_SCALE, rnd(b, hkv, s_len, d), \
            rnd(b, hkv, s_len, d)
        k[:, :, kv_len:] *= 4
        label = f"decode_attention bf16 {name} q [{b},{hq},1,{d}] cache " \
                f"[{b},{hkv},{s_len},{d}] kv_len {kv_len}"
        want = decode_attention.decode_attention_plain(q, k, v, kv_len)
        before = decode_attention.launches
        check_rows(label, decode_attention.decode_attention(q, k, v, kv_len),
                   want, ATTN_TOL)
        if decode_attention.launches != before + 1:
            raise AssertionError(f"{label}: not one launch")
        control(f"{label} at kv_len {s_len} vs plain at {kv_len}",
                decode_attention.decode_attention(q, k, v, s_len), want,
                ATTN_TOL)
        live = (torch.arange(s_len, device=dev) < kv_len)[None, None, None]
        ms = time_ms(lambda: decode_attention.decode_attention(q, k, v,
                                                               kv_len),
                     reps=50)
        dms = device_ms(lambda: decode_attention.decode_attention(
            q, k, v, kv_len), 50)
        plain_ms = time_ms(lambda: decode_attention.decode_attention_plain(
            q, k, v, kv_len), reps=10)
        lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=live), reps=50)
        bms, by = bound(4.0 * b * hq * d * kv_len, 2 * (
            2 * b * hkv * kv_len * d + 2 * b * hq * d), "bfloat16")
        log("serve_moe_ssm", f"{label}: kernel {ms:.4f} ms (device "
                             f"{dms:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
                             f"(kv_len mask) {lib_ms:.4f} ms, bound "
                             f"{bms:.4f} ms ({by})")
        del q, k, v, want
    torch.cuda.empty_cache()


def decode_layers(cfg) -> int:
    """Layers whose decode steps run decode_attention.cu: attention
    without a window (a windowed layer's step is plain attention)."""
    return sum(cfg.is_attn_layer(i) and cfg.layer_window(i) == 0
               for i in range(cfg.n_layers))


def serve_policies(model, params, prompt, *, n_dfu: int, n_memcopy: int,
                   max_len: int, want_bytes: int, dev, where: str,
                   phase: str = "serve_moe_ssm", extra=None, start=None,
                   want_launches=None) -> tuple:
    """One model through the serving loop: dfu generating ``n_dfu`` tokens,
    then, if ``n_memcopy``, memcopy generating that many; each decode loop
    is the warm-up step and then replays of the Server's captured step.
    Asserts the bytes, migrations and reuses of each policy, the replays,
    tokens equal across them, the gemm, flash and decode launches per
    forward and step, every bf16 flash launch on the wgmma path, and no
    decode cache copy; then the dfu Server's replay checks (no host sync,
    a profiled replay's kernels against the capture's record, the step's
    wall, device time and idle share), and the eager check: the same
    n_dfu tokens with ``Server._decode_step`` called from Python at host
    positions, bit for bit the replays' tokens, with every attention
    kernel call held to its plain version.  Logs the times and the
    (token, choice) pairs each MoE layer drops to its capacity at
    prefill.  ``extra`` and ``start`` go to serve_run (the family's stub
    inputs; a VLM's decode from P + T); ``want_launches(n)`` gives the
    (flash, decode, gemm) launches of a run of n tokens where the
    decoder-only count (one forward's, n times) does not apply.  Returns
    (launches of the dfu and memcopy runs, dfu's tokens, its
    ServeStats)."""
    import torch
    from repro_torch.kernels import attention, decode_attention, gemm
    from repro_torch.models import moe
    cfg = model.cfg
    attn_layers = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    steps_layers = decode_layers(cfg)
    gemms = gemms_per_forward(cfg)
    path = attention.WGMMA if cfg.dtype == "bfloat16" else attention.FMA
    launched = {}

    def add(got):
        for name, n in got.items():
            launched[name] = launched.get(name, 0) + n

    def wanted(n: int) -> tuple:
        return (want_launches(n) if want_launches else
                (attn_layers, steps_layers * (n - 1), gemms * n))

    def expect(run: str, got: dict, n: int) -> None:
        want = wanted(n)
        have = (got["flash_attention"], got["decode_attention"], got["gemm"])
        if have != want:
            raise AssertionError(f"{where} {run}: launches {got}, want "
                                 f"(flash, decode, gemm) {want}")
        if attention.launches_by_path[path] != got["flash_attention"]:
            raise AssertionError(f"{where} {run}: flash launches by path "
                                 f"{attention.launches_by_path}; all must "
                                 f"take the {path} path")
        if decode_attention.copies:
            raise AssertionError(f"{where} {run}: decode_attention copied "
                                 f"the cache {decode_attention.copies} "
                                 f"times; its views must go in uncopied")

    def replayed(run: str, srv, n: int) -> None:
        # the decode loop's first step warms up, the rest replay
        if srv.replays != max(0, n - 2):
            raise AssertionError(f"{where} {run}: {srv.replays} replays "
                                 f"of the captured step, want {n - 2}")

    # the prefill's drops per MoE layer, kept on the card until the end
    real_dispatch, drops = moe.dispatch, []

    def counting(cfg_, idx, cap):
        dest = real_dispatch(cfg_, idx, cap)
        if idx.shape[0] > prompt.shape[0]:
            drops.append((dest == cfg_.n_experts * cap).sum())
        return dest

    moe.dispatch = counting
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        srv, out, pos = serve_run(model, params, "dfu", n_dfu, prompt, dev,
                                  max_len, extra, start)
    finally:
        moe.dispatch = real_dispatch
    got = counts()
    flash_paths = dict(attention.launches_by_path)
    copies = (attention.copies, decode_attention.copies)
    peak = torch.cuda.max_memory_allocated()
    add(got)
    st = srv.stats
    have = (st.bytes_host_to_dev, st.bytes_dev_to_host, st.migrations,
            st.cache_reuses)
    if have != (want_bytes, 0, 1, n_dfu - 1):
        raise AssertionError(f"{where} dfu: (h->d, d->h, migrations, "
                             f"reuses) {have} != "
                             f"{(want_bytes, 0, 1, n_dfu - 1)}")
    expect("dfu", got, n_dfu)
    replayed("dfu", srv, n_dfu)
    if tuple(out.shape) != (prompt.shape[0], n_dfu) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{where} dfu: tokens {out}")
    if cfg.n_experts:
        dropped = [int(x) for x in drops]
        log(phase, f"{where}: (token, choice) pairs dropped to capacity per "
                   f"MoE layer at prefill ({prompt.numel() * cfg.top_k} per "
                   f"layer): {dropped}")
    steps = n_dfu - 1
    log(phase, f"{where} dfu generate({tuple(prompt.shape)}, {n_dfu}): "
               f"prefill {st.prefill_s:.3f} s, decode {st.decode_s:.3f} s "
               f"for {steps} steps, the warm-up and the capture among them "
               f"({st.decode_s / steps * 1e3:.1f} ms per step, "
               f"{st.tokens / st.decode_s:.2f} tokens/s); h->d "
               f"{st.bytes_host_to_dev} B, d->h {st.bytes_dev_to_host} B, "
               f"migrations {st.migrations}, reuses {st.cache_reuses}; "
               f"{srv.replays} replays; launches {got} ((flash, decode, "
               f"gemm) {wanted(n_dfu)}, {gemm.reduce_launches} split-K "
               f"reductions; flash by path {flash_paths}, {copies[0]} "
               f"operand copies; decode {copies[1]} cache copies); peak "
               f"device memory {peak / 1e9:.2f} GB")
    if n_dfu > 2:
        STEP_TIMES[where] = replay_checks(srv, out[:, -1:], pos, where,
                                          phase)
    del srv
    # the eager check: the step run from Python, each attention kernel
    # call also computed by its plain version
    worst = {}
    restore = checked_attention(worst)
    reset_counts()
    try:
        eager, _ = eager_run(model, params, n_dfu, prompt, dev, max_len,
                             extra, start)
    finally:
        restore()
    expect("eager check", counts(), n_dfu)
    if not torch.equal(eager, out):
        raise AssertionError(f"{where}: the replayed steps' tokens "
                             f"{out.tolist()} != the eager step's "
                             f"{eager.tolist()}")
    kernels = {"flash_attention", "decode_attention"} if attn_layers else set()
    if set(worst) != kernels or max(worst.values(), default=0.0) > ATTN_TOL:
        raise AssertionError(f"{where} eager check: kernels vs plain in the "
                             f"path {worst} (tol {ATTN_TOL})")
    log(phase, f"{where} eager check: {n_dfu - 1} steps of "
               f"Server._decode_step at host positions give the replays' "
               f"tokens bit for bit; every attention call vs its plain "
               f"version on the same inputs: "
               + (", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items()))
                  or "none (attention-free)") + f" (tol {ATTN_TOL:g})")
    if not n_memcopy:
        return launched, out, st
    # memcopy: the state round-trips around the prefill and every step,
    # through the captured step's device buffers
    reset_counts()
    mc, out_mc, _ = serve_run(model, params, "memcopy", n_memcopy, prompt,
                              dev, max_len, extra, start)
    got = counts()
    add(got)
    st_mc = mc.stats
    have = (st_mc.bytes_host_to_dev, st_mc.bytes_dev_to_host)
    if have != (n_memcopy * want_bytes, n_memcopy * want_bytes):
        raise AssertionError(f"{where} memcopy: (h->d, d->h) {have} != "
                             f"{n_memcopy} x {want_bytes}")
    if not torch.equal(out_mc, out[:, :n_memcopy]):
        raise AssertionError(f"{where} memcopy tokens {out_mc.tolist()} != "
                             f"dfu's {out[:, :n_memcopy].tolist()}")
    expect("memcopy", got, n_memcopy)
    replayed("memcopy", mc, n_memcopy)
    log(phase, f"{where} memcopy generate(.., {n_memcopy}): prefill "
               f"{st_mc.prefill_s:.3f} s, decode {st_mc.decode_s:.3f} s for "
               f"{n_memcopy - 1} steps ({mc.replays} replays); h->d "
               f"{st_mc.bytes_host_to_dev} B, d->h "
               f"{st_mc.bytes_dev_to_host} B ({n_memcopy} x the state); "
               f"tokens equal dfu's first {n_memcopy}; launches {got}")
    return launched, out, st


def serve_cross_check(cfg, prompt, n: int, dev, where: str,
                      phase: str = "serve_moe_ssm", extra=None,
                      start=None) -> None:
    """The cached steps (eager_run's, which keeps every step's logits)
    against a forward without a cache, at full width over CROSS_LAYERS
    layers (cross_check), with their flash and decode launches asserted;
    they are not counted as the main path's.  ``extra`` and ``start`` as
    eager_run's (a VLM's patches, its decode from P + T)."""
    import dataclasses
    import torch
    small = dataclasses.replace(cfg, n_layers=CROSS_LAYERS)
    model, params = serve_model(small, dev, phase)
    reset_counts()
    out, cached = eager_run(model, params, n, prompt, dev,
                            (start or prompt.shape[1]) + n, extra=extra,
                            start=start)
    cut = cross_check(model, params, prompt, out, cached, dev, where, extra)
    got = counts()
    attn = sum(small.is_attn_layer(i) for i in range(small.n_layers))
    want = (2 * attn, decode_layers(small) * (n - 1))
    if (got["flash_attention"], got["decode_attention"]) != want:
        raise AssertionError(f"{where}: launches {got}, want (flash, "
                             f"decode) {want}")
    if cut["sure"] == 0:
        raise AssertionError(f"{where} at {CROSS_LAYERS} layers: no step "
                             f"has a margin over 2 x {cut['delta']:.4f}")
    log(phase, f"{where}, {CROSS_LAYERS} layers: forward without a cache "
               f"over {cut['tokens']} tokens vs the {n} cached steps: "
               f"max|dlogit| {cut['delta']:.5f} (logits up to "
               f"{cut['top']:.2f}); tokens agree at all {cut['sure']} of "
               f"{cut['steps']} steps whose top-2 margin exceeds 2 x "
               f"max|dlogit| ({cut['agree']} of {cut['steps']} agree in "
               f"all); launches {got} (not counted as the main path's)")
    del params, model
    torch.cuda.empty_cache()


def serve_model(cfg, dev, phase: str = "serve_moe_ssm"):
    """The model of ``cfg`` with seeded random weights made on the card,
    their size logged."""
    import torch
    from repro_torch.models import Model
    model = Model.from_config(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log(phase, f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
               f"vocab {cfg.vocab}, {cfg.dtype}, "
               f"{sum(p.numel() for p in params.parameters())} parameters "
               f"({sum(p.nbytes for p in params.parameters()) / 1e9:.2f} GB)"
               f" made on the card in {time.perf_counter() - t0:.1f} s")
    return model, params


def serve_profile(model, params, prompt, max_len: int, dev, label: str,
                  phase: str = "serve_moe_ssm", extra=None,
                  start=None) -> None:
    """Where one prefill and one decode step spend their time: each once
    under torch.profiler (device_profile; its launches are not counted).
    The decode step sits at ``start`` (default the prompt's length).
    Returns the prefill's device time in ms."""
    import torch
    cache = model.init_cache(prompt.shape[0], max_len, device=dev)
    tok = prompt[:, :1].to(dev)
    start = prompt.shape[1] if start is None else start
    with torch.no_grad():
        prefill_ms = device_profile(lambda: model.forward(
            params, prompt.to(dev), cache=cache, cache_pos=0,
            **(extra or {})),
            f"{label}: one prefill forward {tuple(prompt.shape)}",
            phase=phase, host=True)
        device_profile(lambda: model.forward(
            params, tok, cache=cache, cache_pos=start),
            f"{label}: one decode step (kv_len {start + 1})",
            phase=phase, host=True)
    del cache
    return prefill_ms


def phase_serve_moe_ssm(dev) -> dict:
    """The MoE and SSD blocks through the serving loop: (a)
    granite-moe-1b-a400m and (b) mamba2-1.3b at full width and depth,
    dfu and memcopy; (c) moonshot-v1-16b-a3b at full width over 12 of its
    48 layers, dfu; (d) jamba-1.5-large-398b reduced, one period of its
    mixed (k, v) / (ssm_h, conv) cache, dfu.  These runs are the main
    path; their launches are returned.  Then the kernels at this phase's
    shapes, a cached-vs-uncached cross-check at full width over 2 layers
    for (a) (capacity_factor raised so that no token drops) and (b), and
    a device profile of one prefill and one decode step of (a) and
    (b)."""
    import dataclasses
    import torch
    from repro_torch.models import get_config
    launched: dict = {}
    fresh = dict(prefill_fresh_kv=True)

    def add(got):
        for name, n in got.items():
            launched[name] = launched.get(name, 0) + n

    gen = torch.Generator().manual_seed(1)
    # (a) granite-moe-1b-a400m
    granite = dataclasses.replace(get_config("granite_moe_1b_a400m"),
                                  **fresh)
    model, params = serve_model(granite, dev)
    prompt = torch.randint(0, model.cfg.vocab, (MS_BATCH, MS_PROMPT),
                           generator=gen)
    got, _, _ = serve_policies(model, params, prompt, n_dfu=MS_GEN,
                               n_memcopy=MS_MEMCOPY_GEN, max_len=MS_LEN,
                               want_bytes=GRANITE_CACHE_BYTES, dev=dev,
                               where="(a) granite-moe-1b-a400m")
    add(got)
    serve_profile(model, params, prompt, MS_LEN, dev, "(a) granite")
    granite_prompt = prompt
    del model, params
    torch.cuda.empty_cache()
    # (b) mamba2-1.3b
    model, params = serve_model(get_config("mamba2_1_3b"), dev)
    prompt = torch.randint(0, model.cfg.vocab, (MS_BATCH, MS_PROMPT),
                           generator=gen)
    if state_bytes(model.cfg, MS_BATCH, MS_LEN, 2) != MAMBA_STATE_BYTES or \
            state_bytes(model.cfg, MS_BATCH, 10 * MS_LEN, 2) \
            != MAMBA_STATE_BYTES:
        raise AssertionError("(b) mamba2: the state's bytes depend on "
                             "max_len")
    got, _, _ = serve_policies(model, params, prompt, n_dfu=MS_GEN,
                               n_memcopy=MS_MEMCOPY_GEN, max_len=MS_LEN,
                               want_bytes=MAMBA_STATE_BYTES, dev=dev,
                               where="(b) mamba2-1.3b")
    add(got)
    serve_profile(model, params, prompt, MS_LEN, dev, "(b) mamba2")
    mamba_prompt = prompt
    del model, params
    torch.cuda.empty_cache()
    # (c) moonshot-v1-16b-a3b, depth cut
    model, params = serve_model(dataclasses.replace(
        get_config("moonshot_v1_16b_a3b"), n_layers=MOONSHOT_LAYERS,
        **fresh), dev)
    prompt = torch.randint(0, model.cfg.vocab, (MS_BATCH, MOONSHOT_PROMPT),
                           generator=gen)
    max_len = MOONSHOT_PROMPT + MOONSHOT_GEN
    got, _, _ = serve_policies(
        model, params, prompt, n_dfu=MOONSHOT_GEN, n_memcopy=0,
        max_len=max_len, dev=dev, where="(c) moonshot-v1-16b-a3b x 12",
        want_bytes=state_bytes(model.cfg, MS_BATCH, max_len, 2))
    add(got)
    del model, params
    torch.cuda.empty_cache()
    # (d) jamba-1.5-large-398b reduced
    cfg = dataclasses.replace(
        get_config("jamba_1_5_large_398b").reduced(), **fresh)
    model, params = serve_model(cfg, dev)
    prompt = torch.randint(0, cfg.vocab, (MS_BATCH, JAMBA_PROMPT),
                           generator=gen)
    max_len = JAMBA_PROMPT + JAMBA_GEN
    got, _, _ = serve_policies(
        model, params, prompt, n_dfu=JAMBA_GEN, n_memcopy=0, max_len=max_len,
        dev=dev, where="(d) jamba-1.5-large-398b reduced",
        want_bytes=state_bytes(model.cfg, MS_BATCH, max_len, 4))
    add(got)
    kinds = [("attention (k, v) " if cfg.is_attn_layer(pos) else
              "SSD (ssm_h, conv_state) ")
             + " ".join(f"{list(x.shape)} {str(x.dtype)[6:]}" for x in pair)
             for pos, pair in enumerate(model.init_cache(
                 MS_BATCH, max_len, torch.bfloat16))]
    log("serve_moe_ssm", f"(d) the cache per period position, in a bf16 "
                         f"cache: {kinds}")
    del model, params
    torch.cuda.empty_cache()

    # kernels at this phase's shapes, and the cross-checks (not counted)
    moe_ssm_kernel_checks(dev)
    reset_counts()
    serve_cross_check(dataclasses.replace(
        granite, capacity_factor=granite.n_experts / granite.top_k),
        granite_prompt, MS_GEN, dev,
        "(a) granite cross-check (no drops: capacity = tokens)")
    serve_cross_check(get_config("mamba2_1_3b"), mamba_prompt,
                        MAMBA_CROSS_GEN, dev, "(b) mamba2 cross-check")
    torch.cuda.empty_cache()
    return launched


#: the serve_encdec_vlm phase.  (a) whisper-tiny at full width and depth:
#: batch 4, 1500 ones-valued frames, a 64-token prompt standing for
#: previous-text context (whisper's bare task prefix, 4 tokens, would keep
#: the prefill's self and cross attention below flash's Tq >= 8), 16
#: tokens under dfu and 4 under memcopy, max_len 80
WH_BATCH, WH_PROMPT, WH_GEN, WH_MEMCOPY_GEN = 4, 64, 16, 4
WH_LEN = WH_PROMPT + WH_GEN
#: its cache: 4 decoder layers x (k, v), each (4, 6 heads, slots, 64) in
#: bf16: self over the 80 slots, cross over the 1500 frames
WH_SELF_BYTES = 4 * 2 * WH_BATCH * 6 * WH_LEN * 64 * 2
WH_CROSS_BYTES = 4 * 2 * WH_BATCH * 6 * 1500 * 64 * 2
assert (WH_SELF_BYTES, WH_CROSS_BYTES) == (1_966_080, 36_864_000)
WH_CACHE_BYTES = WH_SELF_BYTES + WH_CROSS_BYTES
assert WH_CACHE_BYTES == 38_830_080
#: the reference's Pallas flash pads Tk to its key block (min(256, Tk))
#: and masks the pads only through the causal test
#: (repro/kernels/attention.py:96-102): at Tk 1500, 36 zero keys
TPU_BK = 256
#: (b) pixtral-12b at full width and depth: batch 2 x (256 patch
#: embeddings + 3840 tokens), decoded from P + T = 4096 (not from T, as
#: the reference's generate would), max_len 4112
PX_BATCH, PX_PATCHES, PX_PROMPT, PX_GEN, PX_MEMCOPY_GEN = 2, 256, 3840, 16, 4
PX_START = PX_PATCHES + PX_PROMPT
PX_LEN = PX_START + PX_GEN
#: its cache: 40 layers x (k, v), each (2, 8 KV heads, 4112, 128) bf16
PX_CACHE_BYTES = 40 * 2 * PX_BATCH * 8 * PX_LEN * 128 * 2
assert PX_CACHE_BYTES == 1_347_420_160


def whisper_launches(cfg, n: int) -> tuple:
    """(flash, decode, gemm) launches of a whisper run of ``n`` tokens.
    The prefill runs the encoder (q, k, v, o, w1, w2 per layer), the
    decoder (self q, k, v, o; cross q, its K/V from the encoder, o; w1,
    w2 per layer) and the tied head, with flash on the encoder's, the
    decoder's self and its cross attention.  A decode step runs the
    decoder without the cross K/V (8 products per layer) and the head,
    decode_attention.cu on self attention; cross attention at Tq 1 is
    plain, as in the reference."""
    enc, dec = cfg.encoder_layers, cfg.n_layers
    return (enc + 2 * dec, dec * (n - 1),
            6 * enc + 10 * dec + 1 + (8 * dec + 1) * (n - 1))


def padded_live(q, k, v):
    """The plain version with the TPU kernel's defect: Tk padded with zero
    keys to its block, the pads left in a non-causal softmax."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    pad = (-k.shape[2]) % min(TPU_BK, k.shape[2])
    return ref.attention(q, F.pad(k, (0, 0, 0, pad)),
                         F.pad(v, (0, 0, 0, pad)), causal=False), pad


def capture_flash(model, params, prompt, extra, max_len: int, dev) -> dict:
    """One prefill forward (not counted), keeping the first flash call's
    inputs of each kind: the encoder's (non-causal, Tq = Tk), the
    decoder's cross attention (non-causal, Tq < Tk) and its self
    attention."""
    import torch
    from repro_torch.kernels import ops
    real, seen = ops.flash_attention, {}

    def keep(q, k, v, **kw):
        kind = ("self" if kw.get("causal", True) else
                "encoder" if q.shape[2] == k.shape[2] else "cross")
        seen.setdefault(kind, (q, k, v, kw))
        return real(q, k, v, **kw)

    ops.flash_attention = keep
    try:
        with torch.no_grad():
            cache = model.init_cache(prompt.shape[0], max_len, device=dev)
            model.forward(params, prompt.to(dev), cache=cache, cache_pos=0,
                          **extra)
    finally:
        ops.flash_attention = real
    return seen


def flash_times(q, k, v, label: str, card: str, phase: str, **kw) -> None:
    """Kernel, plain and sdpa times of one flash call, with its bound
    (flash_bound: the live logits of a causal or full mask)."""
    import torch
    from repro_torch.kernels import attention
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    causal = kw.get("causal", True)
    ms = time_ms(lambda: attention.flash_attention(q, k, v, **kw), reps=5)
    plain_ms = time_ms(lambda: attention.flash_attention_plain(q, k, v, **kw),
                       reps=2)
    lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=causal), reps=5)
    pairs = causal_pairs(tq, 0) if causal else tq * tk
    bms, _, term = flash_bound(b * hq * pairs, d, q.element_size() * (
        2 * b * hq * tq * d + 2 * b * hkv * tk * d), softcap=False,
        dtype="float32" if q.dtype == torch.float32 else "bfloat16")
    log(phase, f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa "
               f"{lib_ms:.3f} ms, bound {bms:.4f} ms ({term}); {card}")


def whisper_flash_checks(seen: dict, card: str) -> None:
    """The encoder's and the cross attention's flash calls of a whisper
    prefill, on their real inputs: the wgmma path, per row against the
    plain version at ATTN_TOL, beside a control that must fail it (the
    plain version with the TPU kernel's padded keys live), and times."""
    from repro_torch.kernels import attention
    for kind in ("encoder", "cross"):
        q, k, v, kw = seen[kind]
        label = (f"flash_attention bf16 whisper {kind} q {list(q.shape)} "
                 f"k, v {list(k.shape)} non-causal, Tk {k.shape[2]} "
                 f"(wgmma path)")
        before = attention.launches_by_path[attention.WGMMA]
        got = attention.flash_attention(q, k, v, **kw)
        if attention.launches_by_path[attention.WGMMA] != before + 1:
            raise AssertionError(f"{label}: not on the wgmma path")
        want = attention.flash_attention_plain(q, k, v, **kw)
        check_rows(label, got, want, ATTN_TOL)
        live, pad = padded_live(q, k, v)
        control(f"{label}: the plain version with its {pad} padded keys "
                f"live (the TPU kernel's non-causal defect)", live, want,
                ATTN_TOL)
        flash_times(q, k, v, label, card, "serve_encdec_vlm", **kw)


def padded_head_backward(dc, x, table, card: str) -> None:
    """Whisper's tied head backward (dA = dC table, dB = x^T dC) as the
    train step runs it, on dC's odd row stride (51865 bf16: TMA cannot
    describe it, so both products take the skinny path), against one copy
    of dC into rows padded to a multiple of 8, which puts both on the
    tensor-core path: times of each and their results held to the plain
    products."""
    import torch
    from repro_torch.kernels import gemm
    m, n = dc.shape
    buf = torch.empty(m, -(-n // 8) * 8, dtype=dc.dtype, device=dc.device)
    padded = buf[:, :n]
    padded.copy_(dc)
    for name, a, b, pa, pb in (("dA", dc, table, padded, table),
                               ("dB", x.mT, dc, x.mT, padded)):
        want = gemm.gemm_plain(a, b)
        check(f"gemm bfloat16 whisper head backward {name} on dC padded to "
              f"row stride {buf.shape[1]}, path {gemm.plan(pa, pb).path}",
              gemm.gemm(pa, pb), want, TOL["bfloat16"])
    skinny = time_ms(lambda: (gemm.gemm(dc, table), gemm.gemm(x.mT, dc)),
                     reps=5)
    copy = time_ms(lambda: padded.copy_(dc), reps=5)
    both = time_ms(lambda: (padded.copy_(dc), gemm.gemm(padded, table),
                            gemm.gemm(x.mT, padded)), reps=5)
    log("serve_encdec_vlm", f"whisper head backward {m}x{n}: dA + dB on dC "
                            f"as it comes (paths {gemm.plan(dc, table).path}"
                            f", {gemm.plan(x.mT, dc).path}) {skinny:.3f} ms;"
                            f" one padded copy of dC {copy:.3f} ms, copy + "
                            f"dA + dB (paths {gemm.plan(padded, table).path}"
                            f", {gemm.plan(x.mT, padded).path}) {both:.3f} "
                            f"ms; {card}")
    del buf, padded


def encdec_vlm_kernel_checks(dev, card: str) -> None:
    """gemm.cu at whisper's ragged vocab head (N 51865, over the tied
    table's transposed view) at prefill, decode and training widths, at
    pixtral's prefill MLP and decode head, and at the largest backward
    products of the train phase (qwen1.5-4b's untied head: dA = dC B^T
    and dB = A^T dC on transposed views, whisper's tied head); flash at
    pixtral's prefill (D 128, 4 query heads per KV head) and decode at
    its cache; each against its plain version with times and bounds."""
    import torch
    from repro_torch.kernels import attention, decode_attention, gemm
    gen = torch.Generator(device=dev).manual_seed(20)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    table = rnd(51865, 384)
    n_pre, n_train = WH_BATCH * WH_PROMPT, 8 * 448
    cases = [
        (f"whisper vocab head {n_pre}x51865x384 (table.mT)", rnd(n_pre, 384),
         table.mT),
        (f"whisper vocab head {WH_BATCH}x51865x384 (table.mT)",
         rnd(WH_BATCH, 384), table.mT),
        (f"whisper vocab head {n_train}x51865x384 (table.mT), training",
         rnd(n_train, 384), table.mT),
        ("whisper head backward dA 3584x384x51865 (dC table)",
         rnd(n_train, 51865), table),
        ("whisper head backward dB 384x51865x3584 (A^T dC)",
         rnd(n_train, 384).mT, rnd(n_train, 51865)),
    ]
    for label, a, b in cases:
        check(f"gemm bfloat16 {label}", gemm.gemm(a, b),
              gemm.gemm_plain(a, b), TOL["bfloat16"])
        gemm_times(a, b, f"{label}, path {gemm.plan(a, b).path}",
                   "serve_encdec_vlm", card)
    padded_head_backward(cases[3][1], cases[4][1].mT, table, card)
    del cases, table
    x, w = rnd(4096, 2560), rnd(2560, 151936)
    dc = rnd(4096, 151936)
    cases = [("qwen1.5-4b head backward dA 4096x2560x151936 (dC B^T)", dc,
              w.mT),
             ("qwen1.5-4b head backward dB 2560x151936x4096 (A^T dC)", x.mT,
              dc)]
    for label, a, b in cases:
        check(f"gemm bfloat16 {label}", gemm.gemm(a, b),
              gemm.gemm_plain(a, b), TOL["bfloat16"])
        gemm_times(a, b, f"{label}, path {gemm.plan(a, b).path}",
                   "serve_encdec_vlm", card)
    del cases, x, w, dc
    cases = [(f"pixtral MLP up {PX_BATCH * PX_START}x14336x5120",
              rnd(PX_BATCH * PX_START, 5120), rnd(5120, 14336)),
             (f"pixtral vocab head {PX_BATCH}x131072x5120",
              rnd(PX_BATCH, 5120), rnd(5120, 131072))]
    for label, a, b in cases:
        check(f"gemm bfloat16 {label}", gemm.gemm(a, b),
              gemm.gemm_plain(a, b), TOL["bfloat16"])
        gemm_times(a, b, f"{label}, path {gemm.plan(a, b).path}",
                   "serve_encdec_vlm", card)
    del cases
    b, hq, hkv, d = PX_BATCH, 32, 8, 128
    q, k, v = rnd(b, hq, PX_START, d) * ATTN_Q_SCALE, \
        rnd(b, hkv, PX_START, d), rnd(b, hkv, PX_START, d)
    label = (f"flash_attention bf16 pixtral [{b},{hq},{PX_START},{d}] / "
             f"[{b},{hkv},{PX_START},{d}] causal (wgmma path)")
    before = attention.launches_by_path[attention.WGMMA]
    got = attention.flash_attention(q, k, v, causal=True)
    if attention.launches_by_path[attention.WGMMA] != before + 1:
        raise AssertionError(f"{label}: not on the wgmma path")
    check_rows(label, got, attention.flash_attention_plain(q, k, v,
                                                           causal=True),
               ATTN_TOL)
    flash_times(q, k, v, label, card, "serve_encdec_vlm", causal=True)
    del q, k, v, got
    kv_len = PX_START + 1
    q, k, v = rnd(b, hq, 1, d) * ATTN_Q_SCALE, rnd(b, hkv, PX_LEN, d), \
        rnd(b, hkv, PX_LEN, d)
    k[:, :, kv_len:] *= 4
    label = (f"decode_attention bf16 pixtral q [{b},{hq},1,{d}] cache "
             f"[{b},{hkv},{PX_LEN},{d}] kv_len {kv_len}")
    want = decode_attention.decode_attention_plain(q, k, v, kv_len)
    check_rows(label, decode_attention.decode_attention(q, k, v, kv_len),
               want, ATTN_TOL)
    control(f"{label} at kv_len {PX_LEN} vs plain at {kv_len}",
            decode_attention.decode_attention(q, k, v, PX_LEN), want,
            ATTN_TOL)
    live = (torch.arange(PX_LEN, device=dev) < kv_len)[None, None, None]
    ms = time_ms(lambda: decode_attention.decode_attention(q, k, v, kv_len),
                 reps=50)
    dms = device_ms(lambda: decode_attention.decode_attention(q, k, v,
                                                              kv_len), 50)
    plain_ms = time_ms(lambda: decode_attention.decode_attention_plain(
        q, k, v, kv_len), reps=10)
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=live), reps=50)
    bms, by = bound(4.0 * b * hq * d * kv_len,
                    2 * (2 * b * hkv * kv_len * d + 2 * b * hq * d),
                    "bfloat16")
    log("serve_encdec_vlm", f"{label}: kernel {ms:.4f} ms (device "
                            f"{dms:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
                            f"(kv_len mask) {lib_ms:.4f} ms, bound "
                            f"{bms:.4f} ms ({by}); {card}")
    del q, k, v, want
    torch.cuda.empty_cache()


def in_session(fn, where: str, dev):
    """``fn()`` inside a DFU offload session with interception on, as
    ``launch/serve.py`` and ``launch/train.py --offload-config`` run it;
    the session must see no fault, retry, fallback or quarantine (the
    model's products reach the kernels through ``ops``, never through a
    guarded unit, so no fault path can hide a broken kernel)."""
    import repro_torch
    from repro_torch import OffloadConfig
    with repro_torch.session(OffloadConfig(policy="dfu"), device=dev,
                             record_trace=False) as s:
        out = fn()
        no_faults(s.stats, where)
    return out


def phase_serve_encdec_vlm(dev) -> dict:
    """The enc-dec and VLM families through the serving loop, with seeded
    random bf16 weights made on the card and prefill_fresh_kv: (a)
    whisper-tiny at full width and depth with ones-valued frames, dfu and
    memcopy (the cross K/V made at prefill replaces the cache's
    placeholder; every attention call of the memcopy run held to its
    plain version); (b) pixtral-12b at full width and depth with 256
    patch embeddings before 3840 tokens, prefill then decode from P + T,
    dfu and memcopy.  These runs are the main path; their launches are
    returned.  Then whisper's encoder and cross flash on their real
    inputs with the TPU-defect control, the kernels at this phase's
    shapes, pixtral's cross-check over 2 layers and a profiled prefill
    and decode step."""
    import dataclasses
    import torch
    from repro_torch.models import get_config
    phase = "serve_encdec_vlm"
    card = card_line()
    launched: dict = {}

    def add(got):
        for name, n in got.items():
            launched[name] = launched.get(name, 0) + n

    gen = torch.Generator().manual_seed(2)
    # (a) whisper-tiny
    cfg = dataclasses.replace(get_config("whisper_tiny"),
                              prefill_fresh_kv=True)
    model, params = serve_model(cfg, dev, phase)
    prompt = torch.randint(0, cfg.vocab, (WH_BATCH, WH_PROMPT),
                           generator=gen)
    frames = {"frames": torch.ones(WH_BATCH, cfg.encoder_seq, cfg.d_model,
                                   dtype=torch.bfloat16, device=dev)}
    got, _, _ = in_session(lambda: serve_policies(
        model, params, prompt, n_dfu=WH_GEN, n_memcopy=WH_MEMCOPY_GEN,
        max_len=WH_LEN, want_bytes=WH_CACHE_BYTES, dev=dev,
        where="(a) whisper-tiny", phase=phase, extra=frames,
        want_launches=lambda n: whisper_launches(cfg, n)),
        "(a) whisper-tiny", dev)
    add(got)
    seen = capture_flash(model, params, prompt, frames, WH_LEN, dev)
    whisper_flash_checks(seen, card)
    del model, params, seen
    torch.cuda.empty_cache()
    # (b) pixtral-12b
    cfg = dataclasses.replace(get_config("pixtral_12b"),
                              prefill_fresh_kv=True)
    model, params = serve_model(cfg, dev, phase)
    prompt = torch.randint(0, cfg.vocab, (PX_BATCH, PX_PROMPT),
                           generator=gen)
    patches = {"patch_embeds": 0.02 * torch.randn(
        PX_BATCH, PX_PATCHES, cfg.d_model, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator(device=dev).manual_seed(3))}
    got, _, _ = in_session(lambda: serve_policies(
        model, params, prompt, n_dfu=PX_GEN, n_memcopy=PX_MEMCOPY_GEN,
        max_len=PX_LEN, want_bytes=PX_CACHE_BYTES, dev=dev,
        where="(b) pixtral-12b", phase=phase, extra=patches,
        start=PX_START), "(b) pixtral-12b", dev)
    add(got)
    serve_profile(model, params, prompt, PX_LEN, dev, "(b) pixtral", phase,
                  extra=patches, start=PX_START)
    del model, params
    torch.cuda.empty_cache()
    encdec_vlm_kernel_checks(dev, card)
    reset_counts()
    serve_cross_check(cfg, prompt, PX_GEN, dev, "(b) pixtral cross-check",
                      phase, extra=patches, start=PX_START)
    torch.cuda.empty_cache()
    return launched


#: the train phase.  (a) whisper-tiny at full width and depth: batch 8 x
#: 448 tokens (whisper's decoder context) and 1500 ones-valued frames,
#: WT_STEPS AdamW steps with a checkpoint every WT_CKPT; the restart from
#: the mid-run checkpoint runs under torch.use_deterministic_algorithms
WT_BATCH, WT_SEQ, WT_STEPS, WT_CKPT = 8, 448, 24, 12
#: (b) qwen1.5-4b at full width over 4 of its 40 layers (float32 masters
#: and AdamW's moments of all 40 would be ~64 GB before activations):
#: batch 4 x 1024, 5 steps
QW_LAYERS, QW_BATCH, QW_SEQ, QW_STEPS = 4, 4, 1024, 5
#: at the reference's TrainConfig (peak lr 3e-4, warmup 20).  The witness
#: fits run it at warmup 1 (3e-4 from the second step on) on the kernels
#: and on the plain versions, to show whose a rise of the loss is
QW_WITNESS_WARMUP = 1
#: the gradient check: one step's loss and every leaf's gradient on the
#: kernels against the same step with every product on gemm_plain and
#: every attention on flash_attention_plain, on the same weights and
#: batch.  Both sides compute in bf16 with float32 sums and differ only
#: in summation order and in flash's bf16 probabilities: a few bf16
#: roundings (2^-8 = 3.9e-3 each) in each activation, so a leaf's
#: gradient moves by about that.  Per leaf |g - g_plain|_2 / |g_plain|_2
#: <= GRAD_TOL; a wrong operand, a transposed gradient or a lost fold is
#: an error of order 1 (the control, dB = dC^T A in place of A^T dC)
GRAD_TOL = 3e-2
#: the loss of that step (a mean over thousands of positions), relative
LOSS_TOL = 1e-3
#: the qwen fit at the reference's settings against the same fit with
#: every product and attention plain: each step's loss, relative
TRAJ_TOL = 1e-2


def forward_products(cfg) -> int:
    """gemm.cu launches of one training forward: whisper's prefill count
    (whisper_launches at one token), else the decoder-only count."""
    if cfg.family == "encdec":
        return whisper_launches(cfg, 1)[2]
    return gemms_per_forward(cfg)


class forced_plain:
    """Every product on gemm_plain and every prefill attention on
    flash_attention_plain while the block runs (through ``ops``, as the
    model calls them): the plain side of the train phase's checks."""

    def __enter__(self):
        from repro_torch.kernels import attention, gemm, ops
        self.saved = ops.gemm, ops.flash_attention
        ops.gemm = lambda a, b, block=0: gemm.gemm_plain(a, b)
        ops.flash_attention = attention.flash_attention_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.gemm, ops.flash_attention = self.saved
        return False


def named_leaves(tree, prefix: str = "") -> list:
    """(path, tensor) of a parameter tree, in ``tree.leaves`` order."""
    from repro_torch.tree import children
    kids = children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for k, child in kids
            for x in named_leaves(child, f"{prefix}.{k}" if prefix
                                  else str(k))]


def loss_and_grads(model, params, batch, tcfg, seen=None) -> tuple:
    """One step's loss and float32 gradient of every leaf (the train
    step's own loss, ``train.loop.make_loss``); ``seen`` keeps the first
    flash call's detached inputs of each kind."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train.loop import make_loss
    from repro_torch.tree import leaves
    real = ops.flash_attention

    def keep(q, k, v, **kw):
        kind = ("self" if kw.get("causal", True) else
                "encoder" if q.shape[2] == k.shape[2] else "cross")
        seen.setdefault(kind, (q.detach(), k.detach(), v.detach(), kw))
        return real(q, k, v, **kw)

    if seen is not None:
        ops.flash_attention = keep
    try:
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "labels")}
        loss = make_loss(model, tcfg)(params, batch["tokens"],
                                      batch["labels"], extra)
        grads = torch.autograd.grad(loss, leaves(params), allow_unused=True)
    finally:
        ops.flash_attention = real
    grads = [torch.zeros_like(p) if g is None else g.float()
             for p, g in zip(leaves(params), grads)]
    return float(loss.detach()), grads


def grad_errors(params, got, want) -> list:
    """(relative L2 error, path) of every leaf's gradient, worst first."""
    out = []
    for (path, _), g, w in zip(named_leaves(params), got, want):
        den = w.norm().item()
        err = (g - w).norm().item()
        out.append((err / den if den else err, path))
    return sorted(out, reverse=True)


def swapped_db(ctx, grad):
    """gemm's backward with a fault (the control): dB = dC^T A, the
    transpose of A^T dC, wherever that has dB's shape (a square weight)."""
    from repro_torch.kernels import gemm
    da, db, _ = gemm._gemm_backward(ctx, grad)
    if db is not None and db.shape[-1] == db.shape[-2]:
        a, _ = ctx.saved_tensors
        db = gemm._gemm(gemm._matrix(grad).mT, a, block=ctx.block)
    return da, db, None


def grad_check(model, params, batch, tcfg, where: str, card: str, *,
               loss_tol: float = LOSS_TOL, grad_tol: float = GRAD_TOL,
               path: str = "wgmma", row_tol: float = ATTN_TOL) -> float:
    """One training step's loss and every leaf's gradient through the
    kernels (gemm.cu forward and both backward products, flash forward)
    against the same step forced plain (forced_plain), at ``loss_tol``
    and ``grad_tol`` per leaf (bf16's LOSS_TOL and GRAD_TOL by default);
    the control with gemm's dB transposed must fail it; then every kind
    of flash call the step made, on its own inputs, on ``path`` and per
    row against the plain version at ``row_tol``, with times.  Returns
    the kernel path's loss."""
    from repro_torch.kernels import attention, gemm
    seen: dict = {}
    loss, got = loss_and_grads(model, params, batch, tcfg, seen)
    with forced_plain():
        loss_p, want = loss_and_grads(model, params, batch, tcfg)
    errs = grad_errors(params, got, want)
    rel = abs(loss - loss_p) / abs(loss_p)
    log("train", f"{where} gradient check: loss {loss:.6f} (plain "
                 f"{loss_p:.6f}, rel {rel:.2e}, tol {loss_tol:g}); "
                 f"{len(errs)} leaves, worst relative L2 errors "
                 + ", ".join(f"{p} {e:.2e}" for e, p in errs[:6])
                 + f" (tol {grad_tol:g})")
    bad = [(e, p) for e, p in errs if not e <= grad_tol]
    if not rel <= loss_tol or bad:
        raise AssertionError(f"{where} gradient check: loss rel {rel:.2e}; "
                             f"leaves over {grad_tol:g}: {bad}")
    gemm.gemm_grad.register_autograd(swapped_db,
                                     setup_context=gemm._gemm_setup)
    try:
        _, wrong = loss_and_grads(model, params, batch, tcfg)
    finally:
        gemm.gemm_grad.register_autograd(gemm._gemm_backward,
                                         setup_context=gemm._gemm_setup)
    caught = [(e, p) for e, p in grad_errors(params, wrong, want)
              if not e <= grad_tol]
    if not caught:
        raise AssertionError(f"control {where}: gemm's dB transposed, and "
                             f"no leaf's gradient is over {grad_tol:g}; the "
                             f"check cannot tell")
    log("train", f"control {where}: gemm's dB transposed (dC^T A): "
                 f"{len(caught)} leaves over {grad_tol:g} (worst "
                 f"{caught[0][1]} {caught[0][0]:.2e}), as it must be")
    del got, want, wrong
    for kind, (q, k, v, kw) in sorted(seen.items()):
        label = (f"flash_attention {str(q.dtype)[6:]} {where} training "
                 f"{kind} q {list(q.shape)} k, v {list(k.shape)} "
                 f"{'causal' if kw.get('causal', True) else 'non-causal'} "
                 f"({path} path)")
        before = attention.launches_by_path[path]
        out = attention.flash_attention(q, k, v, **kw)
        if attention.launches_by_path[path] != before + 1:
            raise AssertionError(f"{label}: not on the {path} path")
        check_rows(label, out, attention.flash_attention_plain(q, k, v,
                                                                **kw),
                   row_tol)
        flash_times(q, k, v, label, card, "train", **kw)
    return loss


def dispatch_costs(dev, card: str) -> None:
    """The host's cost per call of entering a kernel through its autograd
    operator rather than through its launch alone, under no_grad as the
    serving loop calls it: gemm at whisper's decode MLP (33 products a
    decode step) and flash at a short prefill.  Wall time per call over
    CALLS back-to-back calls."""
    import torch
    from repro_torch.kernels import attention, gemm
    gen = torch.Generator(device=dev).manual_seed(21)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    a, b = rnd(WH_BATCH, 384), rnd(384, 1536)
    q, k, v = rnd(WH_BATCH, 6, 64, 64), rnd(WH_BATCH, 6, 64, 64), \
        rnd(WH_BATCH, 6, 64, 64)
    calls = 2000
    cases = [("gemm 4x1536x384, launch alone (gemm.gemm)",
              lambda: gemm.gemm(a, b)),
             ("gemm 4x1536x384, operator (gemm.gemm_grad)",
              lambda: gemm.gemm_grad(a, b, 0)),
             ("flash [4,6,64,64] causal, launch alone",
              lambda: attention.flash_attention(q, k, v, causal=True)),
             ("flash [4,6,64,64] causal, operator",
              lambda: attention.flash_attention_grad(q, k, v, True, 0, 0.0,
                                                     None))]
    with torch.no_grad():
        for label, fn in cases:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / calls * 1e6
            log("train", f"host cost per call, {label}: {us:.2f} us wall "
                         f"over {calls} calls; {card}")


def fit_counted(trainer, where: str, flash_per_step: int) -> tuple:
    """``trainer.fit()`` with the launch counts set to 0 just before it:
    asserts 3 gemm launches per forward product per step (the forward,
    dA and dB: every product's operands both take a gradient here), the
    forward's flash launches per step, all on the wgmma path, and no
    decode launch; every step after the first a replay of the captured
    step, whose record counts one step's launches; returns (launches,
    history, wall seconds, peak bytes)."""
    import torch
    from repro_torch.kernels import attention
    cfg = trainer.model.cfg
    steps = trainer.tcfg.steps - trainer.step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    hist = trainer.fit(verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = (3 * forward_products(cfg) * steps, flash_per_step * steps, 0)
    have = (got["gemm"], got["flash_attention"], got["decode_attention"])
    if have != want:
        raise AssertionError(f"{where}: launches {got}, want (gemm, flash, "
                             f"decode) {want}")
    if attention.launches_by_path[attention.WGMMA] != want[1]:
        raise AssertionError(f"{where}: flash launches by path "
                             f"{attention.launches_by_path}")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{where}: losses {losses} not finite and "
                             f"falling")
    replays_counted(trainer, steps, where,
                    {"gemm": want[0] // steps,
                     "flash_attention": flash_per_step,
                     "decode_attention": 0})
    return got, hist, wall, torch.cuda.max_memory_allocated()


def remat_counts(trainer, batch, flash_fwd: int, where: str,
                 extra_fn=None) -> None:
    """One step under remat "dots" and "full" on copies of the trained
    weights: dots saves the 2-D products' outputs (3 gemm launches per
    product, flash again in the recompute), full recomputes the whole
    forward (4 per product, flash twice); then a fresh Trainer under each
    mode, 3 steps: the warm-up, the capture and a replay, each replay
    counting that step's launches.  Not counted as the main path's."""
    import dataclasses
    import torch
    from repro_torch.optim import init_compression
    from repro_torch.train import Trainer, make_train_step
    from repro_torch.tree import leaves, unflatten
    products = forward_products(trainer.model.cfg)
    for remat, per_product in (("dots", 3), ("full", 4)):
        params = unflatten(trainer.params, [x.detach().clone() for x in
                                            leaves(trainer.params)])
        tcfg = dataclasses.replace(trainer.tcfg, remat=remat)
        step = make_train_step(trainer.model, tcfg, trainer.opt)
        reset_counts()
        _, _, _, met = step(params, trainer.opt.init(params),
                            init_compression(params), batch, 1)
        got = counts()
        want = (per_product * products, 2 * flash_fwd)
        if (got["gemm"], got["flash_attention"]) != want:
            raise AssertionError(f"{where} remat {remat}: launches {got}, "
                                 f"want (gemm, flash) {want}")
        log("train", f"{where} remat={remat}: one step, loss "
                     f"{float(met['loss']):.4f}, launches {got} (gemm "
                     f"{per_product} x {products}, flash 2 x {flash_fwd})")
        del params, step
        tr = Trainer(trainer.model, trainer.pipe,
                     dataclasses.replace(tcfg, steps=3, ckpt_every=10 ** 9),
                     extra_batch_fn=extra_fn, device=trainer.device)
        reset_counts()
        hist = tr.fit(verbose=False)
        got = counts()
        if (got["gemm"], got["flash_attention"]) != (3 * want[0],
                                                    3 * want[1]):
            raise AssertionError(f"{where} remat {remat}, captured: "
                                 f"launches {got} over 3 steps, want 3 x "
                                 f"{want}")
        replays_counted(tr, 3, f"{where} remat={remat}",
                        {"gemm": want[0], "flash_attention": want[1]})
        if not all(math.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"{where} remat {remat}: losses {hist}")
        del tr
        torch.cuda.empty_cache()


def restart_check(trainer, ckpt_dir: str, extra_fn, where: str) -> None:
    """A new trainer resumes from the mid-run checkpoint (step WT_CKPT)
    alone and runs to the end; its weights must equal the uninterrupted
    run's bit for bit.  Both runs are under deterministic algorithms
    (the index and gather backwards then sum in a fixed order); the ops
    that warned they have no deterministic form are named."""
    import shutil
    import tempfile
    import torch
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        shutil.copytree(os.path.join(ckpt_dir, f"step_{WT_CKPT}"),
                        os.path.join(d, f"step_{WT_CKPT}"))
        tr = Trainer(trainer.model, trainer.pipe, trainer.tcfg, ckpt_dir=d,
                     extra_batch_fn=extra_fn, device=trainer.device)
        hist = tr.fit(verbose=False)
    if len(hist) != WT_STEPS - WT_CKPT or tr.step != WT_STEPS or \
            tr.replays != WT_STEPS - WT_CKPT - 1:
        raise AssertionError(f"{where} restart: ran {len(hist)} steps to "
                             f"{tr.step}, {tr.replays} of them replays")
    pairs = list(zip(leaves(tr.params), leaves(trainer.params)))
    same = sum(torch.equal(a, b) for a, b in pairs)
    worst = max((a - b).abs().max().item() for a, b in pairs)
    if same != len(pairs):
        raise AssertionError(f"{where} restart: {len(pairs) - same} of "
                             f"{len(pairs)} weights differ from the "
                             f"uninterrupted run's (max |diff| {worst:.3e})")
    losses = [h["loss"] for h in hist]
    want = [h["loss"] for h in trainer.history[WT_CKPT:]]
    if losses != want:
        raise AssertionError(f"{where} restart: losses {losses} != the "
                             f"uninterrupted run's {want}")
    log("train", f"{where}: resumed from step {WT_CKPT} alone, ran to step "
                 f"{WT_STEPS} (a warm-up, then {tr.replays} replays of its "
                 f"own capture): all {len(pairs)} weights bit for bit the "
                 f"uninterrupted run's, losses equal")


def train_replay_checks(tr, batch, where: str, phase: str,
                        reps: int = 5) -> dict:
    """A Trainer whose step is captured, after its fit: the replay
    measured and checked by measure_replays against the same step run
    eagerly from Python on the same buffers (``Trainer._update``), which
    is also profiled once.  These steps train on, outside the main
    path's counts.  Returns the replayed step's wall ms (unprofiled),
    device ms and idle share, and the eager step's wall ms and device
    ms."""
    g = tr.graphed
    if g.graph is None:
        raise AssertionError(f"{where}: the Trainer captured no step")
    batch = {k: v.to(tr.device) for k, v in batch.items()}
    t = measure_replays(lambda: tr._card_step(batch),
                        lambda: tr._update(batch), g.record, where, phase,
                        reps)
    eager_dev = device_profile(lambda: tr._update(batch),
                               f"{where}: the same step eager (not "
                               f"counted)", top=4, phase=phase)
    log(phase, f"{where}: replayed train step: wall {t['wall']:.2f} ms "
               f"(mean of {reps}; {t['prof_wall']:.2f} under the "
               f"profiler), device {t['device']:.2f} ms, idle share "
               f"{t['idle']:.3f}; the eager step on the same buffers "
               f"{t['eager']:.2f} ms (mean of {reps}); no host sync in a "
               f"replay; its kernels by name {t['seen']} = the capture's "
               f"record per replay; {tr.replays} replays in all, 1 "
               f"capture; {card_line()}")
    return dict(wall=t["wall"], device=t["device"], idle=t["idle"],
                eager=t["eager"], eager_device=eager_dev)


def replays_counted(tr, steps: int, where: str, per_step: dict,
                    phase: str = "train") -> None:
    """A fresh Trainer's fit of ``steps`` steps: the first eager (the
    warm-up), every later one a replay; one replay counts ``per_step``
    launches (by STEP_KERNELS' names) from the capture's record."""
    got = (record_counts(tr.graphed.record) if tr.graphed.graph
           else None)
    if tr.replays != steps - 1 or got is None or any(
            got[k] != n for k, n in per_step.items()):
        raise AssertionError(f"{where}: {tr.replays} replays of {steps} "
                             f"steps, a replay counts {got}; want "
                             f"{steps - 1} and {per_step}")
    log(phase, f"{where}: {steps} steps = 1 eager warm-up + {tr.replays} replays "
               f"of one captured step; a replay counts {got}")


def phase_train(dev) -> dict:
    """Training through ``repro_torch.train.Trainer``: (a) whisper-tiny at
    full width and depth, WT_STEPS steps of AdamW on float32 masters cast
    to bf16 at every use, every product and its two gradients on gemm.cu
    and the attention forward on flash_attention.cu, a checkpoint every
    WT_CKPT steps, under deterministic algorithms; the restart from the
    mid-run checkpoint; one step each under remat dots and full; a
    profiled step.  (b) qwen1.5-4b at full width over 4 layers, QW_STEPS
    steps at the reference's TrainConfig, held step by step to the same
    fit forced plain, and the witness fits at warmup 1.  Before each fit,
    its first step's loss and gradients are held to the plain step's
    (grad_check).  The two fits are the main path; their launches are
    returned."""
    import dataclasses
    import tempfile
    import warnings
    import torch
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import Model, get_config
    from repro_torch.train import Trainer, TrainConfig
    card = card_line()
    launched: dict = {}

    def add(got):
        for name, n in got.items():
            launched[name] = launched.get(name, 0) + n

    # (a) whisper-tiny
    cfg = get_config("whisper_tiny")
    model = Model.from_config(cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=WT_SEQ,
                                    global_batch=WT_BATCH))

    def frames(step):
        return {"frames": torch.ones(WT_BATCH, cfg.encoder_seq, cfg.d_model,
                                     dtype=torch.bfloat16)}

    tcfg = TrainConfig(steps=WT_STEPS, peak_lr=1e-3, warmup=4,
                       ckpt_every=WT_CKPT)
    flash_fwd = whisper_launches(cfg, 1)[0]
    # the index and gather backwards sum in a fixed order; cuBLAS (the
    # plain attention backward) reads this before its next call
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d, \
                warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            tr = Trainer(model, pipe, tcfg, ckpt_dir=d,
                         extra_batch_fn=frames, device=dev)
            n_params = sum(p.numel() for p in tr.params.parameters())
            batch = {k: v.to(dev) for k, v in pipe.global_batch(0).items()}
            batch.update({k: v.to(dev) for k, v in frames(0).items()})
            first = grad_check(model, tr.params, batch, tcfg,
                               "(a) whisper-tiny", card)
            got, hist, wall, peak = in_session(
                lambda: fit_counted(tr, "(a) whisper-tiny", flash_fwd),
                "(a) whisper-tiny", dev)
            add(got)
            first_loss(first, hist, "(a) whisper-tiny")
            tokens = WT_BATCH * WT_SEQ
            times = sorted(tr.step_times[1:])
            log("train", f"(a) whisper-tiny: {n_params} float32 master "
                         f"weights, batch {WT_BATCH} x {WT_SEQ} tokens + "
                         f"{cfg.encoder_seq} frames, {WT_STEPS} steps in "
                         f"{wall:.2f} s; step median {times[len(times) // 2] * 1e3:.1f} "
                         f"ms ({tokens / times[len(times) // 2]:.0f} "
                         f"tokens/s), first {tr.step_times[0] * 1e3:.1f} ms; "
                         f"loss {hist[0]['loss']:.4f} -> "
                         f"{hist[-1]['loss']:.4f} (grad_norm "
                         f"{hist[-1]['grad_norm']:.3f}); launches {got} "
                         f"(gemm 3 x {forward_products(cfg)} per step, flash "
                         f"{flash_fwd}); peak device memory "
                         f"{peak / 1e9:.2f} GB; {card}")
            log("train", "(a) losses: " + " ".join(
                f"{h['loss']:.4f}" for h in hist))
            restart_check(tr, d, frames, "(a) whisper-tiny")
            remat_counts(tr, batch, flash_fwd, "(a) whisper-tiny", frames)
            t = TRAIN_TIMES["whisper-tiny"] = train_replay_checks(
                tr, batch, "(a) whisper-tiny", "train")
            MEASURED["whisper-tiny train step"] = t["device"]
        names = sorted({str(w.message).split(" does not have")[0]
                        for w in warned if "deterministic" in
                        str(w.message)})
        log("train", f"(a) ops without a deterministic form: "
                     f"{names or 'none warned'}")
    finally:
        torch.use_deterministic_algorithms(False)
    del tr, batch
    torch.cuda.empty_cache()
    dispatch_costs(dev, card)
    # (b) qwen1.5-4b, depth cut, at the reference's TrainConfig
    cfg = dataclasses.replace(get_config("qwen1_5_4b"), n_layers=QW_LAYERS)
    model = Model.from_config(cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=QW_SEQ,
                                    global_batch=QW_BATCH))
    tcfg = TrainConfig(steps=QW_STEPS)
    tr = Trainer(model, pipe, tcfg, device=dev)
    n_params = sum(p.numel() for p in tr.params.parameters())
    batch = {k: v.to(dev) for k, v in pipe.global_batch(0).items()}
    first = grad_check(model, tr.params, batch, tcfg, "(b) qwen1.5-4b x 4",
                       card)
    del batch
    got, hist, wall, peak = in_session(
        lambda: fit_counted(tr, "(b) qwen1.5-4b x 4", cfg.n_layers),
        "(b) qwen1.5-4b x 4", dev)
    add(got)
    first_loss(first, hist, "(b) qwen1.5-4b x 4")
    times = sorted(tr.step_times[1:])
    log("train", f"(b) qwen1.5-4b x {QW_LAYERS} layers: {n_params} float32 "
                 f"master weights, batch {QW_BATCH} x {QW_SEQ}, {QW_STEPS} "
                 f"steps (peak lr {tcfg.peak_lr:g}, warmup {tcfg.warmup}) "
                 f"in {wall:.2f} s; step median "
                 f"{times[len(times) // 2] * 1e3:.1f} ms "
                 f"({QW_BATCH * QW_SEQ / times[len(times) // 2]:.0f} "
                 f"tokens/s); loss " + " ".join(f"{h['loss']:.4f}"
                                                for h in hist)
                 + f"; launches {got} (gemm 3 x {forward_products(cfg)} "
                 f"per step); peak device memory {peak / 1e9:.2f} GB; "
                 f"{card}")
    del tr
    torch.cuda.empty_cache()
    plain = plain_fit(model, pipe, tcfg, dev)
    worst = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(hist, plain))
    log("train", f"(b) the same fit forced plain: loss " + " ".join(
        f"{h['loss']:.4f}" for h in plain) + f"; worst step relative "
        f"difference {worst:.2e} (tol {TRAJ_TOL:g})")
    if not worst <= TRAJ_TOL:
        raise AssertionError(f"(b) qwen1.5-4b x 4: the kernels' losses "
                             f"{[h['loss'] for h in hist]} leave the plain "
                             f"fit's {[h['loss'] for h in plain]}")
    witness = dataclasses.replace(tcfg, warmup=QW_WITNESS_WARMUP)
    tr = Trainer(model, pipe, witness, device=dev)
    kern = tr.fit(verbose=False)
    del tr
    torch.cuda.empty_cache()
    plain = plain_fit(model, pipe, witness, dev)
    log("train", f"(b) witness at peak lr {witness.peak_lr:g}, warmup "
                 f"{witness.warmup}: kernels' loss " + " ".join(
                     f"{h['loss']:.4f}" for h in kern) + "; plain "
                 + " ".join(f"{h['loss']:.4f}" for h in plain) + f"; {card}")
    if not all(math.isfinite(h["loss"]) for h in kern + plain):
        raise AssertionError("(b) witness: a loss is not finite")
    torch.cuda.empty_cache()
    return launched


def first_loss(loss: float, hist: list, where: str) -> None:
    """The gradient check's step is the fit's first: same weights, same
    batch, so the same loss."""
    if not abs(loss - hist[0]["loss"]) <= LOSS_TOL * abs(loss):
        raise AssertionError(f"{where}: the gradient check's loss {loss} "
                             f"is not the fit's first {hist[0]['loss']}")


def plain_fit(model, pipe, tcfg, dev) -> list:
    """A fit from the same seed and data with every product and attention
    plain (forced_plain); its history."""
    import torch
    from repro_torch.train import Trainer
    with forced_plain():
        tr = Trainer(model, pipe, tcfg, device=dev)
        hist = tr.fit(verbose=False)
    del tr
    torch.cuda.empty_cache()
    return hist


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


# ----------------------------------------------------------------------- #
# the mesh phase                                                           #
# ----------------------------------------------------------------------- #
#: decode steps after the a2a prefill (launch/specs.py's decode_step each,
#: the first the GraphedStep's warm-up, the rest replays of one capture)
MESH_DECODE = 8
#: the dry run's cells, each in its own process with its own time limit
#: (s): the launcher's documented example, jamba at full width, and an
#: SSD model's training on the two-pod mesh, whose batch shards hold
#: fewer rows than the model dim has ranks
DRYRUN_CELLS = (("qwen2_5_32b", "train_4k", "single", 420),
                ("jamba_1_5_large_398b", "long_500k", "multi", 420),
                ("mamba2_1_3b", "train_4k", "multi", 420))
#: the roofline counts' process (gemma2-9b prefill, whisper-tiny step)
COUNT_LIMIT = 420
#: a whole step's compute bound over its profiled device time may not
#: exceed this: a count under which the card beats its own bound is a
#: miscount (the margin is for the profiler's clock)
BOUND_RATIO_MAX = 1.05


def count_steps(out_path: str) -> None:
    """(e)'s counts, on the CPU (run in a subprocess): the dry run's
    counter over gemma2-9b's prefill forward at 2 x 4608 as the serve
    phase profiles it (a 4624-slot cache, every position's logits) and
    over whisper-tiny's training step at 8 x 448 with 1500 frames as the
    train phase profiles it, each on a 1-rank mesh over a fake group and
    fake tensors."""
    import dataclasses
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model, get_config
    from repro_torch.models.sharding import axis_env
    dryrun.fake_group(1)
    mesh = make_debug_mesh(1, model=1, device="cpu")
    out = {}
    with axis_env(specs.axis_env_for(mesh)):
        cfg = dataclasses.replace(get_config("gemma2_9b"),
                                  prefill_fresh_kv=True)
        model = Model.from_config(cfg)

        @torch.no_grad()
        def prefill(params, tokens, cache):
            return model.forward(params, tokens, cache=cache, cache_pos=0)

        with FakeTensorMode():
            args = (specs.param_structs(model, mesh, master=False),
                    specs._batch((SERVE_BATCH, SERVE_PROMPT), torch.int64,
                                 mesh),
                    specs._cache_specs(model, SERVE_BATCH, SERVE_LEN, mesh,
                                       seq_shard=False))
            cell = specs.Cell("gemma2_9b", None, specs._implicit(prefill),
                              args)
            counted, _, wall = dryrun.count_cell(cell)
        out["gemma2-9b prefill"] = dict(
            flops_by_dtype=counted.flops_by_dtype, bytes=counted.bytes,
            wall_s=wall, what=f"prefill forward {SERVE_BATCH} x "
                              f"{SERVE_PROMPT}, cache {SERVE_LEN}")
        model = Model.from_config(get_config("whisper_tiny"))
        shape = specs.ShapeCell("whisper_step", "train", WT_SEQ, WT_BATCH)
        with FakeTensorMode():
            cell = specs.build_cell(model, "whisper_tiny", shape, mesh,
                                    remat="none")
            counted, _, wall = dryrun.count_cell(cell)
        out["whisper-tiny train step"] = dict(
            flops_by_dtype=counted.flops_by_dtype, bytes=counted.bytes,
            wall_s=wall, what=f"training step {WT_BATCH} x {WT_SEQ} "
                              f"tokens + 1500 frames, AdamW")
    Path(out_path).write_text(json.dumps(out))


def _background(name: str, cmd: list, limit: float) -> tuple:
    """A CPU process of the mesh or apps phase, started now: (name, Popen,
    limit, start time)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, limit, time.perf_counter()


def _finish(job, phase: str = "mesh") -> str:
    """Wait for a background process within its limit; its output."""
    name, proc, limit, t0 = job
    try:
        out, _ = proc.communicate(timeout=max(1.0, limit - (
            time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{phase}: {name} ran past its {limit} s "
                             f"limit")
    if proc.returncode != 0:
        raise AssertionError(f"{phase}: {name} exited {proc.returncode}:\n"
                             f"{out[-3000:]}")
    return out


def mesh_graphed(model, params, prompt, cache, mesh, dev,
                 where: str) -> dict:
    """The mesh path's main run: launch/specs.py's prefill_step (eager),
    then MESH_DECODE of its decode_step through one GraphedStep (the
    first the warm-up, the second captured and replayed, the rest
    replays), under the mesh's axis env with moe_impl="a2a", the counts
    set to 0 just before and read just after.  The collectives per
    replay and the launches per replay are the capture's record's; the
    collectives of the prefill, the warm-up and the capture are
    CommDebugMode's (the capture issues none on the card: it records
    them).  Then the replayed step measured (measure_replays, the eager
    decode_step at the same host position on the same buffers beside
    it).  The graph is released before this returns or raises: the
    process group cannot be destroyed while a graph that captured its
    collectives lives.  Returns the tokens (B, MESH_DECODE + 1), the
    launches, the all-to-alls in all and per replay, the record's
    launches per replay, the replays, the wall s and the replay's
    timings."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.kernels import compat
    from repro_torch.launch import specs
    from repro_torch.models.sharding import axis_env
    env = specs.axis_env_for(mesh)
    step = compat.GraphedStep(specs.decode_step(model, "a2a"), dev,
                              fresh=(1,))
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    try:
        torch.cuda.synchronize()
        reset_counts()
        compat.collectives.clear()
        t0 = time.perf_counter()
        with torch.no_grad(), axis_env(env), CommDebugMode() as comm:
            tok, cache = specs.prefill_step(model, "a2a")(params, prompt,
                                                          cache, {})
            toks = [tok]
            for i in range(MESH_DECODE):
                pos.fill_(MS_PROMPT + i)
                toks.append(step(params, toks[-1][:, None], cache, pos)[0]
                            .clone())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        seen = sum(v for k, v in comm.get_comm_counts().items()
                   if "all_to_all" in str(k))
        per_replay = {k: v for counters, moves in step.record
                      if counters is compat.collectives
                      for k, v in moves.items()}
        a2a = (seen - per_replay.get("all_to_all_single", 0)
               + compat.collectives["all_to_all_single"])
        if step.replays != MESH_DECODE - 1 or step.graph is None:
            raise AssertionError(f"{where}: {step.replays} replays of "
                                 f"{MESH_DECODE} decode steps, want "
                                 f"{MESH_DECODE - 1} after one warm-up")
        eager_step = specs.decode_step(model, "a2a")
        at, last = MS_PROMPT + MESH_DECODE, toks[-1][:, None]

        def replay():
            pos.fill_(at)
            step(params, last, cache, pos)

        def eager():
            eager_step(params, last, cache, at)

        with axis_env(env):
            t = measure_replays(replay, eager, step.record, where, "mesh")
        return dict(toks=torch.stack([
            x.full_tensor() if hasattr(x, "full_tensor") else x
            for x in toks], 1), got=got, a2a=a2a, per_replay=per_replay,
            per=record_counts(step.record), replays=MESH_DECODE - 1,
            wall=wall, t=t)
    finally:
        step.release()


def mesh_eager(model, params, prompt, cache, mesh, impl: str, feed):
    """The check: the prefill, then MESH_DECODE decode steps run from
    Python at host positions (the step the graph captures, uncaptured),
    each fed ``feed``'s token, keeping every forward's last-position
    logits.  Returns (tokens (B, MESH_DECODE + 1), logits (B,
    MESH_DECODE + 1, vocab) float32)."""
    import torch
    from repro_torch.launch import specs
    from repro_torch.models.sharding import axis_env
    forward, kept = model.forward, []

    def keeping(params_, tokens, **kw):
        logits, aux, cache_ = forward(params_, tokens, **kw)
        last = logits[:, -1]
        last = last.full_tensor() if hasattr(last, "full_tensor") else last
        kept.append(last.float())
        return logits, aux, cache_

    model.forward = keeping
    try:
        with torch.no_grad(), axis_env(specs.axis_env_for(mesh)):
            tok, cache = specs.prefill_step(model, impl)(params, prompt,
                                                         cache, {})
            toks = [tok]
            step = specs.decode_step(model, impl)
            for i in range(MESH_DECODE):
                toks.append(step(params, feed[:, i:i + 1], cache,
                                 MS_PROMPT + i)[0])
    finally:
        model.forward = forward
    toks = torch.stack([t.full_tensor() if hasattr(t, "full_tensor")
                        else t for t in toks], 1)
    return toks, torch.stack(kept, 1)


def mesh_a2a(dev, mesh, card: str) -> tuple:
    """(a) granite-moe-1b-a400m at full width and depth, batch 2 x 4096,
    on plain per-rank blocks under the 1-rank mesh's axis env, moe_impl
    "a2a" (the main path, mesh_graphed: the prefill, then MESH_DECODE
    decode steps from one capture).  Then the eager check (mesh_eager fed
    the graph's tokens: bit for bit), the replayed step measured against
    the eager one, the same calls on the scatter plan fed the same
    tokens, and one MoE layer's a2a output against its scatter output on
    the hidden states the a2a prefill gave it.  Returns (the launches,
    the graph's tokens, the eager a2a logits, the parameters)."""
    import dataclasses
    import torch
    from repro_torch.kernels import attention
    from repro_torch.launch import specs
    from repro_torch.models import get_config, moe
    from repro_torch.models.sharding import axis_env
    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m"),
                              prefill_fresh_kv=True)
    model, params = serve_model(cfg, dev, "mesh")
    prompt = torch.randint(0, cfg.vocab, (MS_BATCH, MS_PROMPT),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    env = specs.axis_env_for(mesh)
    max_len = MS_PROMPT + MESH_DECODE + 1

    def fresh():
        return model.init_cache(MS_BATCH, max_len, torch.bfloat16, device=dev)

    r = mesh_graphed(model, params, prompt, fresh(), mesh, dev, "mesh (a)")
    toks, got, a2a, per, t = r["toks"], r["got"], r["a2a"], r["per"], r["t"]
    per_a2a = r["per_replay"].get("all_to_all_single", 0)
    n_fwd = MESH_DECODE + 1
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    # under a2a the router and expert products are torch.matmul/einsum
    # (the reference's shard_map body, outside its kernels): q, k, v, o
    # per attention layer and the vocab head stay on gemm.cu
    gemm_fwd = 4 * cfg.n_layers + 1
    want = {"gemm": gemm_fwd * n_fwd, "flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * MESH_DECODE}
    if (gemm_fwd != 97 or per_a2a != 2 * moe_layers
            or a2a != 2 * moe_layers * n_fwd
            or per["gemm"] != gemm_fwd
            or per["decode_attention"] != cfg.n_layers
            or any(got[k] != v for k, v in want.items())):
        raise AssertionError(f"mesh (a): launches {got}, all-to-alls {a2a} "
                             f"({per_a2a} per replay), the record's "
                             f"launches per replay {per}; want {want}, "
                             f"{2 * moe_layers * n_fwd} ({2 * moe_layers})")
    if attention.launches_by_path[attention.WGMMA] != cfg.n_layers:
        raise AssertionError(f"mesh (a): flash by path "
                             f"{attention.launches_by_path}, all wgmma")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError("mesh (a): bad tokens")
    log("mesh", f"(a) granite-moe a2a on the (data=1, model=1) mesh, plain "
                f"per-rank blocks: prefill {MS_BATCH} x {MS_PROMPT} + "
                f"{MESH_DECODE} decode steps (1 warm-up, then "
                f"{r['replays']} replays of one capture) in "
                f"{r['wall']:.3f} s; {a2a} all-to-alls = 2 x {moe_layers} "
                f"MoE layers x {n_fwd} forwards; collectives per replay "
                f"from the capture's record {r['per_replay']}; launches "
                f"{got} (gemm {gemm_fwd} per forward, flash all wgmma at D "
                f"64; per replay {per}); {card}")
    STEP_TIMES["mesh (a) granite-moe a2a"] = {
        k: t[k] for k in ("wall", "device", "idle", "eager")}
    log("mesh", f"(a) replayed decode step: wall {t['wall']:.2f} ms (mean "
                f"of 5; {t['prof_wall']:.2f} under the profiler), device "
                f"{t['device']:.2f} ms, idle share {t['idle']:.3f}; the "
                f"eager step on the same buffers {t['eager']:.2f} ms (mean "
                f"of 5); no host sync in a replay; its kernels by name "
                f"{t['seen']} = the record per replay; {card}")
    # the eager check, fed the graph's tokens; the first MoE layer's input
    real_moe, seen = moe.moe_fwd, []

    def keep_first(p, cfg_, x, impl="scatter"):
        if not seen and x.shape[1] > 1:
            seen.append((p, x.detach().clone()))
        return real_moe(p, cfg_, x, impl=impl)

    moe.moe_fwd = keep_first
    try:
        etoks, logits = mesh_eager(model, params, prompt, fresh(), mesh,
                                   "a2a", toks[:, :MESH_DECODE])
    finally:
        moe.moe_fwd = real_moe
    if not torch.equal(etoks, toks):
        bad = (etoks != toks).nonzero().tolist()
        raise AssertionError(f"mesh (a): the replayed tokens differ from "
                             f"the eager step's at (row, step) {bad}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("mesh (a): non-finite logits")
    log("mesh", f"(a) the eager check (decode_step from Python at host "
                f"positions, fed the same tokens): {toks.numel()} tokens bit "
                f"for bit the graph's; {card}")
    # the scatter plan on the a2a run's tokens, not counted
    _, ref = mesh_eager(model, params, prompt, fresh(), mesh, "scatter",
                        toks[:, :MESH_DECODE])
    delta = (logits - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * delta
    agree = toks == ref.argmax(-1)
    if not bool(agree[sure].all()) or int(sure.sum()) == 0:
        raise AssertionError(f"mesh (a): a2a tokens differ from scatter's "
                             f"at steps with margin > 2 x {delta:.4f}, or "
                             f"no step has such a margin")
    log("mesh", f"(a) a2a vs scatter on the same tokens: max|dlogit| "
                f"{delta:.5f}; tokens agree at all {int(sure.sum())} of "
                f"{agree.numel()} steps whose top-2 margin exceeds 2 x "
                f"max|dlogit| ({int(agree.sum())} agree in all); {card}")
    # one MoE layer, at a capacity with no drops in either plan
    p, x = seen[0]
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
    with torch.no_grad(), axis_env(env):
        want_out, _ = moe.moe_fwd(p, nodrop, x, impl="scatter")
        got_out, _ = moe.moe_fwd_a2a(p, nodrop, x, mesh, env.batch,
                                     env.model)
    rel = row_rel(got_out, want_out)
    if not rel <= ATTN_TOL:
        raise AssertionError(f"mesh (a): first MoE layer a2a vs scatter "
                             f"per-row rel err {rel:.3e} > {ATTN_TOL}")
    log("mesh", f"(a) first MoE layer on the a2a prefill's hidden states "
                f"{tuple(x.shape)}, no drops: a2a vs scatter per-row rel "
                f"err {rel:.3e} (tol {ATTN_TOL}); {card}")
    del seen, ref
    torch.cuda.empty_cache()
    return got, (model, params, prompt, toks, logits)


def mesh_dtensor(dev, mesh, card: str, plain) -> dict:
    """(f) granite's decode step as build_cell's decode cells compute it,
    on real DTensors over the mesh: the parameters placed by
    shardings.param_shardings (specs.place_params), the cache by the
    cache specs (specs.place_cache), the prompt over data; the main path
    as (a) (mesh_graphed: the prefill eager, the decode steps from one
    capture, the counts set to 0 just before).  Its tokens bit for bit
    its eager DTensor step's fed the same tokens; against (a)'s plain
    blocks, on the steps whose fed tokens agree, the tokens agree
    wherever (a)'s top-2 margin exceeds 2 max|dlogit|.  Returns the
    launches."""
    import torch
    from repro_torch.launch import shardings as shd
    from repro_torch.launch import specs
    from repro_torch.models.sharding import P
    model, params, prompt, toks_a, logits_a = plain
    cfg = model.cfg
    max_len = MS_PROMPT + MESH_DECODE + 1
    t0 = time.perf_counter()
    dparams = specs.place_params(params, mesh, cfg)
    dprompt = specs._dist(prompt, shd.NamedSharding(mesh, P("data", None)))

    def fresh():
        return specs.place_cache(model.init_cache(
            MS_BATCH, max_len, torch.bfloat16, device=dev), max_len, mesh)

    cache = fresh()
    torch.cuda.synchronize()
    placed = time.perf_counter() - t0
    r = mesh_graphed(model, dparams, dprompt, cache, mesh, dev, "mesh (f)")
    del cache
    toks, got, a2a, per, t = r["toks"], r["got"], r["a2a"], r["per"], r["t"]
    per_a2a = r["per_replay"].get("all_to_all_single", 0)
    n_fwd = MESH_DECODE + 1
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    gemm_fwd = 4 * cfg.n_layers + 1
    want = {"gemm": gemm_fwd * n_fwd, "flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * MESH_DECODE}
    if (per_a2a != 2 * moe_layers or a2a != 2 * moe_layers * n_fwd
            or per["gemm"] != gemm_fwd
            or per["decode_attention"] != cfg.n_layers
            or any(got[k] != v for k, v in want.items())):
        raise AssertionError(f"mesh (f): launches {got}, all-to-alls {a2a} "
                             f"({per_a2a} per replay), the record's "
                             f"launches per replay {per}; want {want}, "
                             f"{2 * moe_layers * n_fwd} ({2 * moe_layers})")
    log("mesh", f"(f) granite-moe a2a decode step on DTensors over the "
                f"(data=1, model=1) mesh (placed in {placed:.1f} s): "
                f"prefill + {MESH_DECODE} decode steps (1 warm-up, then "
                f"{r['replays']} replays of one capture) in "
                f"{r['wall']:.3f} s; {a2a} all-to-alls; collectives per "
                f"replay from the capture's record {r['per_replay']}; "
                f"launches {got} (per replay {per}); {card}")
    STEP_TIMES["mesh (f) granite-moe a2a, DTensors"] = {
        k: t[k] for k in ("wall", "device", "idle", "eager")}
    log("mesh", f"(f) replayed DTensor decode step: wall {t['wall']:.2f} ms "
                f"(mean of 5; {t['prof_wall']:.2f} under the profiler), "
                f"device {t['device']:.2f} ms, idle share {t['idle']:.3f}; "
                f"the eager DTensor step on the same buffers "
                f"{t['eager']:.2f} ms (mean of 5); no host sync in a "
                f"replay; its kernels by name {t['seen']} = the record per "
                f"replay; {card}")
    etoks, logits = mesh_eager(model, dparams, dprompt, fresh(), mesh, "a2a",
                               toks[:, :MESH_DECODE])
    if not torch.equal(etoks, toks):
        bad = (etoks != toks).nonzero().tolist()
        raise AssertionError(f"mesh (f): the replayed tokens differ from "
                             f"the eager DTensor step's at (row, step) "
                             f"{bad}")
    # the forwards whose inputs agree with (a)'s: the prompt, then every
    # decode step up to the first fed token that differs
    same = 1
    while same < MESH_DECODE + 1 and torch.equal(toks[:, same - 1],
                                                 toks_a[:, same - 1]):
        same += 1
    delta = (logits[:, :same] - logits_a[:, :same]).abs().max().item()
    top2 = logits_a[:, :same].topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * delta
    agree = toks[:, :same] == toks_a[:, :same]
    if not bool(agree[sure].all()) or int(sure.sum()) == 0:
        raise AssertionError(f"mesh (f): DTensor tokens differ from the "
                             f"plain blocks' at steps with margin > 2 x "
                             f"{delta:.4f}, or no step has such a margin")
    log("mesh", f"(f) the eager DTensor check: {toks.numel()} tokens bit for "
                f"bit the graph's; against (a)'s plain blocks over the "
                f"{same} forwards fed the same tokens: max|dlogit| "
                f"{delta:.5f}, tokens agree at all {int(sure.sum())} steps "
                f"whose top-2 margin exceeds 2 x max|dlogit| "
                f"({int(agree.sum())} of {agree.numel()} agree in all; "
                f"{int(torch.equal(toks, toks_a))} = all {toks.numel()} "
                f"equal); {card}")
    del dparams, logits
    torch.cuda.empty_cache()
    return got


def mesh_psum_restore(dev, mesh, card: str) -> None:
    """(b) compressed_psum over whisper-tiny's gradient leaves on the
    NCCL group equals compress_decompress with a zero residual, bit for
    bit; (c) a whisper-tiny checkpoint restored with shardings= onto the
    mesh comes back bit for bit, each leaf a DTensor on the card."""
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import shardings as shd
    from repro_torch.models import Model, get_config
    from repro_torch.optim import (CompressionState, compress_decompress,
                                   compressed_psum)
    from repro_torch.train import TrainConfig
    from repro_torch.tree import leaves
    cfg = get_config("whisper_tiny")
    model = Model.from_config(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev,
                        master=True)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=WT_SEQ,
                                    global_batch=WT_BATCH))
    batch = {k: v.to(dev) for k, v in pipe.global_batch(0).items()}
    batch["frames"] = torch.ones(WT_BATCH, cfg.encoder_seq, cfg.d_model,
                                 dtype=torch.bfloat16, device=dev)
    _, grads = loss_and_grads(model, params, batch, TrainConfig())
    group = mesh.get_group("data")
    t0 = time.perf_counter()
    summed = [compressed_psum(g, group) for g in grads]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want, _ = compress_decompress(grads, CompressionState(
        [torch.zeros_like(g) for g in grads]))
    bad = [i for i, (a, b) in enumerate(zip(summed, want))
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"mesh (b): compressed_psum differs from "
                             f"compress_decompress on leaves {bad}")
    log("mesh", f"(b) compressed_psum over {len(grads)} gradient leaves "
                f"({sum(g.numel() for g in grads)} values) on the NCCL "
                f"group: bit for bit compress_decompress with a zero "
                f"residual; {wall * 1e3:.1f} ms; {card}")
    sh = shd.param_shardings(params, mesh, cfg)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        store = CheckpointStore(d)
        store.save(1, params)
        tree, manifest = store.restore(params, shardings=sh)
    got = leaves(tree)
    for i, (a, b, s) in enumerate(zip(got, leaves(params), leaves(sh))):
        if (a.to_local().device != dev or list(a.placements) != s.placements
                or not torch.equal(a.full_tensor(), b.detach())):
            raise AssertionError(f"mesh (c): leaf {i} came back "
                                 f"{a.placements} on {a.to_local().device}"
                                 f", or not bit for bit")
    log("mesh", f"(c) whisper-tiny checkpoint (step {manifest['step']}, "
                f"{len(got)} leaves) restored with shardings= onto the "
                f"1-rank CUDA mesh: every leaf a DTensor on {dev}, bit for "
                f"bit; {card}")
    del params, grads, summed, tree
    torch.cuda.empty_cache()


def mesh_dryrun(jobs: list, card: str) -> None:
    """(d) the dry run's cells: status ok, FLOPs > 0; wall, dominant
    term and both rooflines printed."""
    for (arch, shape, mesh_name, _), job in zip(DRYRUN_CELLS, jobs):
        out = _finish(job)
        path = ROOT / "build" / "dryrun" / f"{arch}__{shape}__{mesh_name}.json"
        rec = json.loads(path.read_text())
        if rec["status"] != "ok" or not rec["cost"]["flops"] > 0:
            raise AssertionError(f"mesh (d): {arch} {shape} {mesh_name}: "
                                 f"{rec['status']} {rec.get('error')}\n"
                                 f"{out[-2000:]}")
        for key, name in (("roofline", "V5E"), ("roofline_h100", "H100")):
            r = rec[key]
            log("mesh", f"(d) dry run {arch} {shape} {mesh_name} "
                        f"({rec['chips']} ranks, CPU fake tensors): wall "
                        f"{rec['wall_s']} s; {name}: dominant "
                        f"{r['dominant']}, compute {r['t_compute_s']} s, "
                        f"memory {r['t_memory_s']} s (unfused bytes), "
                        f"collective {r['t_collective_s']} s, roofline "
                        f"fraction {r['roofline_fraction']}, useful FLOPs "
                        f"{r['useful_flops_ratio']}; {card}")
        log("mesh", f"(d) {arch}: per-rank FLOPs {rec['cost']['flops']:.4e}"
                    f", collectives {rec['collectives']}, peak memory "
                    f"{rec['memory']['peak_size_in_bytes'] / 1e9:.2f} GB "
                    f"per rank; {card}")


def mesh_roofline(job, card: str) -> None:
    """(e) each whole step's compute bound on the H100 against the device
    time the serve and train phases profiled in this run.  The counted
    FLOPs are the plain versions' products, which take bf16 operands to
    float32; on the card they run in bf16 (gemm.cu, flash), but for
    training's plain attention backward in float32, so the bound takes
    them all at the bf16 peak: a lower bound either way."""
    _finish(job)
    counted = json.loads((ROOT / "build" / "mesh_counts.json").read_text())
    for name, rec in counted.items():
        measured = MEASURED.get(name)
        if measured is None:
            raise AssertionError(f"mesh (e): no profiled device time for "
                                 f"{name}")
        bound_s = sum(rec["flops_by_dtype"].values()) / PEAK_OPS["bfloat16"]
        bytes_s = rec["bytes"] / PEAK_BYTES
        ratio = bound_s * 1e3 / measured
        if not ratio <= BOUND_RATIO_MAX:
            raise AssertionError(f"mesh (e): {name}: bound {bound_s:.4f} s "
                                 f"over measured {measured:.1f} ms = "
                                 f"{ratio:.3f} > {BOUND_RATIO_MAX}: a "
                                 f"miscount")
        flops = " ".join(f"{dt} {n:.4e}"
                         for dt, n in sorted(rec["flops_by_dtype"].items()))
        log("mesh", f"(e) {name} ({rec['what']}): counted FLOPs {flops}; "
                    f"H100 compute bound {bound_s * 1e3:.2f} ms, device "
                    f"time {measured:.2f} ms (profiled this run): bound / "
                    f"measured {ratio:.3f}; the unfused bytes' term "
                    f"{bytes_s * 1e3:.1f} ms is no bound (every "
                    f"intermediate counted, flash's included); counted in "
                    f"{rec['wall_s']:.1f} s on the CPU; {card}")


def phase_mesh(dev) -> dict:
    """The mesh paths on the card: (a), (f), (b) and (c) on a (data=1,
    model=1) mesh over a 1-rank NCCL group (a FileStore under build/; no
    network), while (d) the dry run's cells and (e)'s counts run on
    the CPU in processes of their own.  (a) and (f) are the main path;
    their launches are returned."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    card = card_line()
    jobs = [_background(f"dry run {a} {s} {m}", [
        sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
        "--shape", s, "--mesh", m, "--out", str(ROOT / "build" / "dryrun")],
        limit) for a, s, m, limit in DRYRUN_CELLS]
    counting = _background("roofline counts", [
        sys.executable, "-c", "import sys, chip_smoke; "
        "chip_smoke.count_steps(sys.argv[1])",
        str(ROOT / "build" / "mesh_counts.json")], COUNT_LIMIT)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            dist.init_process_group(
                "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
                rank=0, world_size=1, device_id=dev)
            try:
                mesh = make_debug_mesh(1, model=1, device="cuda")
                launched, plain = mesh_a2a(dev, mesh, card)
                got = mesh_dtensor(dev, mesh, card, plain)
                launched = {k: v + got[k] for k, v in launched.items()}
                del plain
                mesh_psum_restore(dev, mesh, card)
            finally:
                dist.destroy_process_group()
        mesh_dryrun(jobs, card)
        mesh_roofline(counting, card)
    finally:
        for _, proc, _, _ in jobs + [counting]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return launched


#: the apps phase: the twins of the reference's drivers
#: (repro_torch.examples), each through its own main on the card.
#: (b) LSMS at its production KKR width, run_mini(atoms 2, energies 2, scf
#: 1, n 6912, complex128): 4 zgemm calls t @ G per policy, G
#: host-first-touched (one n^2 complex128 plane), the t-matrix born on the
#: card
APPS_LSMS_N, APPS_LSMS_ATOMS, APPS_LSMS_ENERGIES = 6912, 2, 2
LSMS_G_BYTES = APPS_LSMS_N * APPS_LSMS_N * 16
assert LSMS_G_BYTES == 764_411_904
#: the H100 model's prediction of the live DFU session's zgemm seconds
#: (its trace replayed through memtier.spec.H100) over the synchronized
#: live seconds.  The model charges each call max(flops / (gpu_flops x
#: eff), bytes / gpu_local_bw) at gemm.cu's measured float64 rate, plus
#: the link copy of every operand on its first use; it leaves out the
#: 4M's split and sum of the complex planes and the host's dispatch, and
#: charges the card-born t-matrix a copy the live run does not make (the
#: trace does not say where a buffer was born).  Each of these is a few
#: to ~20% of a call (PERF.md §6), so the ratio sits near 1; a constant
#: off by 2x in the dominant term (the DMMA rate) leaves the band
REPLAY_BAND = (0.5, 2.0)
#: (c) PARSEC's subspace iteration at ngrid 8192 (H 536,870,912 B dense),
#: nstates 256: 12 filter passes of order 10 (the driver's 8 leave the
#: lower half ~2e-6 from eigvalsh at this size, 12 ~3e-9 on the CPU)
DFT_NGRID, DFT_NSTATES, DFT_SCF, DFT_CHEB = 8192, 256, 12, 10
#: (d) the driver's serving run at mamba2-1.3b's full width and depth:
#: batch 4 x 16 prompt tokens, 32 generated, max_len 96, float32 cache
SO_BATCH, SO_GEN, SO_LEN = 4, 32, 96
#: (e) train_100m at its widths and batch (8 x 256 tokens, n_micro 2, remat
#: dots), its own 300 steps with a checkpoint every 100: the captured step
#: replays at its device time, where the eager step's 435-551 ms had cut
#: the run to 150 steps
T100_STEPS, T100_BATCH, T100_SEQ, T100_CKPT, T100_MICRO = 300, 8, 256, 100, 2
#: the float32 gradient check of (e): both sides are IEEE float32 (TF32
#: refused) and differ only in summation order (gemm.cu's FMA tiles
#: against cuBLAS, flash's online softmax against the full one): each
#: product's sum carries ~sqrt(K) eps32 ~ 3e-6 relative (K <= 3072), and
#: a leaf's gradient sums ~170 products' worth of such errors over 12
#: layers, ~1e-4 at most where a weight's gradient cancels over 2048
#: positions; 1e-3 per leaf leaves a tenfold margin, and a wrong operand
#: is an error of order 1.  The loss is a mean of 2048 terms: 1e-5
GRAD_TOL_F32 = 1e-3
LOSS_TOL_F32 = 1e-5
#: seconds each background replay of the production traces may take
#: (two specs x four policies; ~60 s for LSMS on this container's CPU)
REPLAY_LIMIT = 900


def lsms_expected(policy: str, calls: int, atoms: int, g: int) -> dict:
    """The zgemm counters of run_mini's t @ G calls under ``policy``, from
    core/policy.py's rules: the t-matrix is born on the card, G on the
    host (``g`` bytes), the product is one such plane."""
    if policy == "cpu":
        # never offloads: the host path streams G to the card every call
        return dict(offloaded=0, on_host=calls, bytes_in=0, bytes_out=0,
                    cache_hits=0, cache_misses=0, transient_bytes=calls * g)
    if policy == "memcopy":
        # G staged in and the product staged out around every call; the
        # card-born t-matrix is already there (a hit, no copy)
        return dict(offloaded=calls, on_host=0, bytes_in=calls * g,
                    bytes_out=calls * g, cache_hits=calls,
                    cache_misses=calls, transient_bytes=0)
    # dfu and counter (G is read m times >= 100, within the budget): G
    # moves on its first use per atom and hits after; each t-matrix is
    # registered in place (a miss moving nothing)
    return dict(offloaded=calls, on_host=0, bytes_in=atoms * g, bytes_out=0,
                cache_hits=calls - atoms, cache_misses=calls + atoms,
                transient_bytes=0)


def apps_quickstart() -> dict:
    """(a) quickstart on the card, then the same twin on the CPU: every
    counter equal, but for the small mm's two 64 x 64 slices of host
    arrays, which the card streams (pinned host memory) and the simulated
    tier counts as device-born (a view is a new, untagged tensor)."""
    import copy
    from repro_torch.examples import quickstart
    reset_counts()
    card = quickstart.main([])
    launched = counts()
    cpu = quickstart.main(["--device", "cpu"])
    want = copy.deepcopy(cpu["counters"])
    want["sgemm"]["transient_bytes"] += 2 * 64 * 64 * 4
    if card["counters"] != want:
        raise AssertionError(f"apps (a): card counters {card['counters']} "
                             f"!= the CPU twin's with the slices streamed "
                             f"{want}")
    if (launched["gemm"], sum(launched.values())) != (8, 8):
        raise AssertionError(f"apps (a): launches {launched}, want 8 gemm "
                             f"(7 offloaded sgemm and the small one on the "
                             f"host path; the gemv is the library's)")
    log("apps", f"(a) quickstart: counters {card['counters']} (the CPU "
                f"twin's, sgemm transient_bytes "
                f"{cpu['counters']['sgemm']['transient_bytes']} there); "
                f"mean reuse {card['reuse']:.1f}, result tier "
                f"{card['tier']}; launches {launched}")
    return launched


def apps_calibration(dev, card: str) -> None:
    """The H100 model's rates against this run's launch/calibrate.py
    (before the phase's CPU processes start: the host's rates would share
    its cores with them)."""
    from repro_torch.launch import calibrate
    from repro_torch.memtier.spec import SPECS
    rates = calibrate.measure(dev, log=lambda m: log("apps", m))
    h = SPECS["h100"]
    for key, spec_value in (("link_bw", h.link_bw),
                            ("gpu_local_bw", h.gpu_local_bw),
                            ("cpu_flops", h.cpu_flops),
                            ("cpu_local_bw", h.cpu_local_bw),
                            ("launch_s", h.kernel_launch_s)):
        log("apps", f"calibration {key}: {rates[key]:.4g} now, "
                    f"{spec_value:.4g} in memtier.spec.H100 "
                    f"({rates[key] / spec_value:.3f}x)")
    log("apps", f"calibration gemm.cu float64 rate "
                f"{rates['gemm_f64_flops']:.4g} now, "
                f"{h.gpu_flops * h.eff('gpu', 'zgemm'):.4g} in the spec; "
                f"{card}")


def apps_lsms(dev, card: str) -> dict:
    """(b) must_lsms at n 6912 under cpu, memcopy, counter and dfu, each
    its own session with sync on: energies, residuals and every zgemm
    counter against lsms_expected; the live DFU trace replayed through
    the H100 model against the live zgemm seconds."""
    from repro_torch.examples import must_lsms
    from repro_torch.memtier import replay_trace
    from repro_torch.memtier.spec import SPECS
    calls = APPS_LSMS_ATOMS * APPS_LSMS_ENERGIES
    reset_counts()
    t0 = time.perf_counter()
    out = must_lsms.main(["--n", str(APPS_LSMS_N), "--atoms",
                          str(APPS_LSMS_ATOMS), "--energies",
                          str(APPS_LSMS_ENERGIES), "--scf", "1", "--sync",
                          "--part", "live"])["policies"]
    wall = time.perf_counter() - t0
    launched = counts()
    e0 = out["dfu"]["energy"]
    for policy, r in out.items():
        z = r["zgemm"]
        want = lsms_expected(policy, calls, APPS_LSMS_ATOMS, LSMS_G_BYTES)
        have = {k: z[k] for k in want}
        if have != want or z["calls"] != calls:
            raise AssertionError(f"apps (b) {policy}: zgemm {have} (calls "
                                 f"{z['calls']}) != {want}")
        if not (abs(r["energy"] - e0) <= LSMS_ENERGY_RTOL * abs(e0)
                and r["max_resid"] < LSMS_RESID):
            raise AssertionError(f"apps (b) {policy}: energy "
                                 f"{r['energy']!r} vs dfu's {e0!r}, "
                                 f"max_resid {r['max_resid']:.3e}")
        log("apps", f"(b) LSMS n={APPS_LSMS_N} {policy}: energy "
                    f"{r['energy']:.12f}, max_resid {r['max_resid']:.3e}, "
                    f"zgemm {z['seconds']:.4f} s for {calls} calls "
                    f"(synchronized), bytes_in {z['bytes_in']}, bytes_out "
                    f"{z['bytes_out']}, transient {z['transient_bytes']}, "
                    f"hits {z['cache_hits']}"
                    + (" (the host path computes on the card: not a CPU "
                       "baseline)" if policy == "cpu" else "") + f"; {card}")
    if (launched["gemm"], sum(launched.values())) != (4 * 4 * calls,
                                                      4 * 4 * calls):
        raise AssertionError(f"apps (b): launches {launched}, want "
                             f"{4 * 4 * calls} gemm (4 policies x {calls} "
                             f"calls x the 4M's 4 planes)")
    rep = replay_trace(out["dfu"]["trace"], spec=SPECS["h100"],
                       policies=("dfu",))["dfu"]
    pred = rep.per_routine_s["zgemm"]
    live = out["dfu"]["zgemm"]["seconds"]
    ratio = pred / live
    log("apps", f"(b) the live dfu trace ({len(out['dfu']['trace'])} "
                f"calls) on the H100 model: zgemm {pred:.4f} s predicted "
                f"(movement {rep.movement_s:.4f} s, h->d "
                f"{rep.bytes_host_to_dev} B) against {live:.4f} s live: "
                f"ratio {ratio:.3f} (band {REPLAY_BAND}); loop wall "
                f"{wall:.2f} s for the 4 policies; launches {launched}")
    if not REPLAY_BAND[0] <= ratio <= REPLAY_BAND[1]:
        raise AssertionError(f"apps (b): the H100 model's zgemm {pred:.4f} "
                             f"s / live {live:.4f} s = {ratio:.3f} is out "
                             f"of {REPLAY_BAND}: a spec constant is wrong")
    return launched


def apps_parsec(card: str) -> dict:
    """(c) parsec_dft at ngrid 8192, nstates 256 under dfu: the Ritz
    values' lower half within 1e-6 of eigvalsh (the twin's own check),
    nothing moved (H and psi are born on the card), every dgemm offloaded
    and one gemm.cu launch each."""
    from repro_torch.examples import parsec_dft
    reset_counts()
    t0 = time.perf_counter()
    out = parsec_dft.main(["--ngrid", str(DFT_NGRID), "--nstates",
                           str(DFT_NSTATES), "--scf", str(DFT_SCF),
                           "--cheb-order", str(DFT_CHEB), "--sync",
                           "--part", "live"])["live"]
    wall = time.perf_counter() - t0
    launched = counts()
    d = out["stats"].per_routine["dgemm"]
    calls = 3 + DFT_SCF * (DFT_CHEB + 3)
    have = (d.calls, d.offloaded, d.bytes_in, d.transient_bytes)
    if have != (calls, calls, 0, 0):
        raise AssertionError(f"apps (c): dgemm (calls, offloaded, bytes_in, "
                             f"transient) {have} != ({calls}, {calls}, 0, 0)")
    if (launched["gemm"], sum(launched.values())) != (calls, calls):
        raise AssertionError(f"apps (c): launches {launched}, want {calls} "
                             f"gemm")
    if not out["max_err_low_half"] < 1e-6:
        raise AssertionError(f"apps (c): Ritz error {out['max_err_low_half']}")
    log("apps", f"(c) PARSEC ngrid {DFT_NGRID} nstates {DFT_NSTATES} scf "
                f"{DFT_SCF}: max_err(low half) "
                f"{out['max_err_low_half']:.3e} (< 1e-6), ritz_min "
                f"{out['ritz_min']:.9f}; dgemm {d.calls} calls all "
                f"offloaded, bytes_in 0, {d.seconds:.3f} s synchronized; "
                f"wall {wall:.2f} s (with the host's dense eigvalsh); "
                f"launches {launched}; {card}")
    return launched


def apps_serve(card: str) -> dict:
    """(d) serve_offload on mamba2-1.3b at full width and depth with a
    float32 cache: tokens bit for bit across dfu, memcopy and pinned (the
    twin's own check, and here), each policy's bytes, migrations and
    reuses as train/serve.py counts them, 97 gemm launches per forward."""
    import torch
    from repro_torch.examples import serve_offload
    from repro_torch.models import get_config
    cfg = get_config("mamba2_1_3b")
    state = state_bytes(cfg, SO_BATCH, SO_LEN, 4)
    steps = SO_GEN - 1
    want = {"dfu": (state, 0, steps, 1, steps * SO_BATCH),
            "memcopy": (SO_GEN * state, SO_GEN * state, 0, 0,
                        steps * SO_BATCH),
            "pinned": (0, 0, steps, 0, steps * SO_BATCH)}
    made, real_server = [], serve_offload.Server

    class Recorded(real_server):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    reset_counts()
    serve_offload.Server = Recorded
    try:
        out = serve_offload.main(["--no-reduced"])
    finally:
        serve_offload.Server = real_server
    launched = counts()
    if [srv.replays for srv in made] != [steps - 1] * len(out):
        raise AssertionError(f"apps (d): replays per Server "
                             f"{[srv.replays for srv in made]}, want "
                             f"{steps - 1} each (a warm-up, then replays)")
    for policy, (tokens, st) in out.items():
        have = (st.bytes_host_to_dev, st.bytes_dev_to_host, st.cache_reuses,
                st.migrations, st.tokens)
        if have != want[policy]:
            raise AssertionError(f"apps (d) {policy}: (h->d, d->h, reuses, "
                                 f"migrations, tokens) {have} != "
                                 f"{want[policy]}")
        log("apps", f"(d) mamba2-1.3b {policy}: prefill {st.prefill_s:.3f} "
                    f"s, decode {st.decode_s:.3f} s for {steps} steps "
                    f"({st.decode_s / steps * 1e3:.1f} ms per step); h->d "
                    f"{st.bytes_host_to_dev} B, d->h {st.bytes_dev_to_host} "
                    f"B, migrations {st.migrations}, reuses "
                    f"{st.cache_reuses}; {card}")
    tokens = out["dfu"][0]
    if tuple(tokens.shape) != (SO_BATCH, SO_GEN) or not all(
            torch.equal(t, tokens) for t, _ in out.values()):
        raise AssertionError(f"apps (d): tokens differ across policies: "
                             f"{ {p: t.tolist() for p, (t, _) in out.items()} }")
    per_forward = gemms_per_forward(cfg)
    forwards = len(out) * SO_GEN
    if (launched["gemm"], sum(launched.values())) != (
            per_forward * forwards, per_forward * forwards):
        raise AssertionError(f"apps (d): launches {launched}, want "
                             f"{per_forward} gemm per forward x {forwards}")
    log("apps", f"(d) tokens {tuple(tokens.shape)} equal under "
                f"{sorted(out)}; the state {state} B (float32 ssm_h and "
                f"conv_state); launches {launched} ({per_forward} per "
                f"forward); {steps - 1} replays per Server")
    # the replays against the step run from Python, then the last
    # Server's replay checks
    srv = made[-1]
    prompt = torch.randint(0, cfg.vocab, (SO_BATCH, serve_offload.PROMPT),
                           generator=torch.Generator().manual_seed(1))
    reset_counts()
    eager, _ = eager_run(srv.model, srv.params, SO_GEN, prompt, srv.device,
                         SO_LEN, cache_dtype=torch.float32)
    if not torch.equal(eager, tokens):
        raise AssertionError(f"apps (d): the replays' tokens differ from "
                             f"the eager step's")
    log("apps", f"(d) eager check: {steps} steps of Server._decode_step "
                f"at host positions give the replays' tokens bit for bit")
    STEP_TIMES["apps (d) mamba2-1.3b, float32 state"] = replay_checks(
        srv, tokens[:, -1:], serve_offload.PROMPT + SO_GEN - 1,
        f"(d) mamba2-1.3b {srv.scfg.offload_policy}", "apps")
    del made, srv
    return launched


def apps_train_kernels(dev, card: str) -> None:
    """gemm.cu's FMA path at the 100M model's float32 training shapes of
    one microbatch (M = 4 x 256) and flash's FMA path at its attention,
    each against its plain version, with times, bound and library."""
    import torch
    from repro_torch.kernels import attention, gemm
    gen = torch.Generator(device=dev).manual_seed(22)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    m = T100_BATCH // T100_MICRO * T100_SEQ
    x, h = rnd(m, 768), rnd(m, 3072)
    table, dc = rnd(32000, 768), rnd(m, 32000)
    cases = (("MLP gate/up forward", x, rnd(768, 3072)),
             ("MLP down forward", h, rnd(3072, 768)),
             ("tied head forward, B = table.mT", x, table.mT),
             ("tied head dB = A^T dC", x.mT, dc))
    for label, a, b in cases:
        name = (f"{a.shape[0]}x{b.shape[1]}x{a.shape[1]} {label} "
                f"(repro-100m, FMA)")
        check(f"gemm float32 {name}", gemm.gemm(a, b), gemm.gemm_plain(a, b),
              TOL["float32"])
        gemm_times(a, b, name, phase="apps", card=card)
    q, k, v = (rnd(T100_BATCH // T100_MICRO, 12, T100_SEQ, 64)
               for _ in range(3))
    label = (f"flash_attention float32 [{T100_BATCH // T100_MICRO}, 12, "
             f"{T100_SEQ}, 64] causal (repro-100m, FMA path)")
    before = attention.launches_by_path[attention.FMA]
    got = attention.flash_attention(q, k, v, causal=True)
    if attention.launches_by_path[attention.FMA] != before + 1:
        raise AssertionError(f"{label}: not on the FMA path")
    check_rows(label, got, attention.flash_attention_plain(q, k, v,
                                                            causal=True),
               TOL["float32"])
    flash_times(q, k, v, label, card, "apps", causal=True)


def apps_train(dev, card: str) -> dict:
    """(e) train_100m at its widths over T100_STEPS steps: first the
    twin's first step through
    the kernels against the same step forced plain (grad_check, float32
    tolerances, flash on its FMA path) with its control, and the kernels
    at the model's shapes; then the twin's main: its launches (gemm.cu 3
    per product per microbatch, flash twice per layer per microbatch
    under remat dots, all FMA), every step after the first a replay, a
    finite falling loss, a checkpoint every T100_CKPT steps, the last
    restored bit for bit; then the replayed step's checks
    (train_replay_checks)."""
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.examples import train_100m
    from repro_torch.kernels import attention
    from repro_torch.models.registry import Model
    from repro_torch.train import Trainer, TrainConfig
    from repro_torch.tree import leaves
    where = "(e) repro-100m"
    cfg = train_100m.CONFIG_100M
    model = Model.from_config(cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=T100_SEQ,
                                    global_batch=T100_BATCH))
    tcfg = TrainConfig(steps=T100_STEPS, n_micro=T100_MICRO, remat="dots",
                       ckpt_every=T100_CKPT, log_every=10)
    tr = Trainer(model, pipe, tcfg, device=dev)
    batch = {k: v.to(dev) for k, v in pipe.global_batch(0).items()}
    first = grad_check(model, tr.params, batch, tcfg, where, card,
                       loss_tol=LOSS_TOL_F32, grad_tol=GRAD_TOL_F32,
                       path=attention.FMA, row_tol=TOL["float32"])
    del tr, batch
    apps_train_kernels(dev, card)
    torch.cuda.empty_cache()
    ckpt = ROOT / "build" / "train_100m_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = train_100m.main(["--steps", str(T100_STEPS), "--ckpt-every",
                           str(T100_CKPT), "--ckpt-dir", str(ckpt)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated()
    trainer, hist = out["trainer"], out["history"]
    products = gemms_per_forward(cfg)
    micro = T100_STEPS * T100_MICRO
    want = (3 * products * micro, 2 * cfg.n_layers * micro, 0)
    have = (launched["gemm"], launched["flash_attention"],
            launched["decode_attention"])
    if have != want or attention.launches_by_path != {
            attention.WGMMA: 0, attention.FMA: want[1]}:
        raise AssertionError(f"{where}: launches {launched} (flash by path "
                             f"{attention.launches_by_path}), want (gemm, "
                             f"flash all FMA, decode) {want}")
    losses = [h["loss"] for h in hist]
    if len(losses) != T100_STEPS or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{where}: losses {losses[:3]}..{losses[-3:]} "
                             f"({len(losses)}) not finite and falling")
    first_loss(first, hist, where)
    replays_counted(trainer, T100_STEPS, where,
                    {"gemm": 3 * products * T100_MICRO,
                     "flash_attention": 2 * cfg.n_layers * T100_MICRO,
                     "decode_attention": 0}, phase="apps")
    steps = sorted((p.name for p in ckpt.iterdir()),
                   key=lambda name: int(name.split("_")[1]))
    want_steps = [f"step_{s}" for s in range(T100_CKPT, T100_STEPS + 1,
                                             T100_CKPT)]
    if steps != want_steps:
        raise AssertionError(f"{where}: checkpoints {steps} != {want_steps}")
    tree, manifest = CheckpointStore(str(ckpt)).restore(trainer._state_tree())
    pairs = list(zip(leaves(tree), leaves(trainer._state_tree())))
    same = sum(torch.equal(a, b) for a, b in pairs)
    if manifest["step"] != T100_STEPS or same != len(pairs):
        raise AssertionError(f"{where}: step {manifest['step']} restored "
                             f"{same} of {len(pairs)} leaves bit for bit")
    shutil.rmtree(ckpt, ignore_errors=True)
    times = sorted(trainer.step_times[1:])
    med = times[len(times) // 2]
    log("apps", f"{where}: {out['params']} parameters (param_count), "
                f"{sum(p.numel() for p in leaves(trainer.params))} float32 "
                f"weights, {T100_STEPS} steps of {T100_BATCH} x {T100_SEQ} "
                f"in {wall:.2f} s; step median {med * 1e3:.1f} ms "
                f"({T100_BATCH * T100_SEQ / med:.0f} tokens/s), first "
                f"{trainer.step_times[0] * 1e3:.1f} ms; straggler events "
                f"{trainer.straggler_events}; loss {losses[0]:.4f} -> "
                f"{losses[-1]:.4f}; launches {launched} (gemm 3 x "
                f"{products} x {T100_MICRO} per step, flash 2 x "
                f"{cfg.n_layers} x {T100_MICRO}, all FMA); checkpoints "
                f"{steps}, step {T100_STEPS} restored bit for bit ({same} "
                f"leaves); peak device memory {peak / 1e9:.2f} GB; {card}")
    log("apps", f"{where} losses every 10 steps: " + " ".join(
        f"{x:.4f}" for x in losses[::10]))
    TRAIN_TIMES["repro-100m"] = train_replay_checks(
        trainer, pipe.global_batch(0), where, "apps")
    del out, trainer, tree
    torch.cuda.empty_cache()
    return launched


def phase_apps(dev) -> dict:
    """The twins of the reference's drivers through their own mains, on
    the card: (a) quickstart, (b) must_lsms at n 6912 under four
    policies, (c) parsec_dft at ngrid 8192, (d) serve_offload on
    mamba2-1.3b at full width and depth, (e) train_100m at its widths
    over T100_STEPS steps; meanwhile CPU processes replay the LSMS and PARSEC production traces
    on the GH200 and H100 models, whose tables print at the end.  Every
    run's launches are the main path's; they are returned."""
    card = card_line()
    apps_calibration(dev, card)
    jobs = [_background(f"{name} production replay", [
        sys.executable, "-m", f"repro_torch.examples.{name}", "--part",
        "replay"], REPLAY_LIMIT) for name in ("must_lsms", "parsec_dft")]
    launched: dict = {}
    try:
        for got in (apps_quickstart(), apps_lsms(dev, card),
                    apps_parsec(card), apps_serve(card),
                    apps_train(dev, card)):
            for name, n in got.items():
                launched[name] = launched.get(name, 0) + n
        for job in jobs:
            t0 = time.perf_counter()
            text = _finish(job, "apps")
            log("apps", f"{job[0]} (waited {time.perf_counter() - t0:.1f} "
                        f"s more):")
            for line in text.splitlines():
                log("apps", f"  {line}")
    finally:
        for _, proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return launched


#: device times (ms) of whole steps that the serve and train phases
#: profile, for the mesh phase's roofline (e)
MEASURED: dict = {}
#: each served model's replayed decode step: wall ms, device ms, idle
#: share (replay_checks), summed up at the end
STEP_TIMES: dict = {}
#: each trained model's replayed step: wall ms, device ms, idle share,
#: the eager step's wall and device ms (train_replay_checks)
TRAIN_TIMES: dict = {}


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
    moe_ssm_launches = phase_serve_moe_ssm(dev)
    encdec_vlm_launches = phase_serve_encdec_vlm(dev)
    train_launches = phase_train(dev)
    mesh_launches = phase_mesh(dev)
    apps_launches = phase_apps(dev)
    for name, row in rows.items():
        row["launches"] = (blas_launches[name] + lsms_launches[name]
                           + solver_launches[name] + venue_launches[name]
                           + runtime_launches.get(name, 0)
                           + serve_launches[name]
                           + moe_ssm_launches.get(name, 0)
                           + encdec_vlm_launches.get(name, 0)
                           + train_launches.get(name, 0)
                           + mesh_launches.get(name, 0)
                           + apps_launches.get(name, 0))
        log("done", f"{name} launches: blas {blas_launches[name]}, lsms "
                    f"{lsms_launches[name]}, solvers "
                    f"{solver_launches[name]}, venue {venue_launches[name]}, "
                    f"runtime {runtime_launches.get(name, 0)}, serve "
                    f"{serve_launches[name]}, serve_moe_ssm "
                    f"{moe_ssm_launches.get(name, 0)}, serve_encdec_vlm "
                    f"{encdec_vlm_launches.get(name, 0)}, train "
                    f"{train_launches.get(name, 0)}, mesh "
                    f"{mesh_launches.get(name, 0)}, apps "
                    f"{apps_launches.get(name, 0)}")
        if row["launches"] == 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 f"main path")
    for where, t in STEP_TIMES.items():
        log("done", f"{where}: replayed decode step wall {t['wall']:.2f} "
                    f"ms, device {t['device']:.2f} ms, idle share "
                    f"{t['idle']:.3f}; eager step {t['eager']:.2f} ms")
    for where, t in TRAIN_TIMES.items():
        log("done", f"{where}: replayed train step wall {t['wall']:.2f} ms, "
                    f"device {t['device']:.2f} ms, idle share "
                    f"{t['idle']:.3f}; eager step {t['eager']:.2f} ms "
                    f"(device {t['eager_device']})")
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
