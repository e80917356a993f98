"""Measure the rates behind ``memtier.spec.H100`` on the card and its host.

    PYTHONPATH=src python -m repro_torch.launch.calibrate [--out FILE]

Every rate of the port's H100 model (``repro_torch/memtier/spec.py``)
that is not a data-sheet number comes from this script.  On ``cuda:0``
and the host beside it:

- ``link_bw``: a pinned host tensor of ``COPY_BYTES`` (1 GiB) copied to
  the card by ``Tensor.to``, the copy ``memspace.put`` makes on a
  placement and ``runtime._harmonize`` on a streamed operand;
- ``d2h_bw``: the same bytes from the card into pinned host memory, the
  copy a Mem-Copy result or a ``memspace.put`` toward the host makes;
- ``gpu_local_bw``: a device-to-device copy of the same bytes, counted
  as read plus write (STREAM's convention);
- ``gemm_f64_flops``: ``csrc/gemm.cu`` on float64 at LSMS's plane,
  6912^3 on DMMA, by CUDA events;
- ``launch_s``: the host's wall per ``gemm.gemm`` call at 64^3, over
  back-to-back calls (the device work is far shorter);
- ``cpu_flops`` and the host's efficiencies: float64 ``torch.matmul``
  at 4096^3 on the CPU, ``torch.linalg.solve_triangular`` 4096 x 256,
  and ``torch.linalg.lu_factor`` on a 6912 x 256 panel (the flops the
  trace counts for a panel, m n^2), each relative to the matmul's rate;
- ``cpu_local_bw``: a float64 triad ``a = b + s c`` over 2^26 elements
  (24 bytes an element) on the CPU, by ``torch.add(..., alpha=s,
  out=a)``: one pass over all the host's cores, where numpy's triad
  would take two passes on one core (its rate is logged beside);
- the host's memory and the card's, as the operating system and the
  driver report them.

Prints one line per rate and, last, a JSON object with the card's name
and power limit.  ``--out`` writes the JSON to a file as well.  Without
a card it exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: bytes of each copy (>= 1 GB, as the spec's link rate asks)
COPY_BYTES = 1 << 30
COPY_REPS = 5
LSMS_N = 6912
HOST_N = 4096
TRIAD_N = 1 << 26


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _median_s(fn, reps: int) -> float:
    """Median wall seconds of ``fn`` (which synchronizes) over ``reps``
    runs after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _events_ms(fn, reps: int) -> float:
    import torch
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


def measure(device="cuda:0", log=print) -> dict:
    """The rates, in bytes/s, FLOP/s and seconds (see the module
    docstring)."""
    import numpy as np
    import torch
    from repro_torch.kernels import gemm
    dev = torch.device(device)
    out: dict = {}
    n = COPY_BYTES // 8
    host = torch.empty(n, dtype=torch.float64, pin_memory=True).fill_(1.0)
    back = torch.empty(n, dtype=torch.float64, pin_memory=True)
    card = torch.empty(n, dtype=torch.float64, device=dev).fill_(2.0)
    other = torch.empty_like(card)

    def h2d():
        x = host.to(dev)
        torch.cuda.synchronize(dev)
        return x

    def d2h():
        back.copy_(card)
        torch.cuda.synchronize(dev)

    out["link_bw"] = COPY_BYTES / _median_s(h2d, COPY_REPS)
    out["d2h_bw"] = COPY_BYTES / _median_s(d2h, COPY_REPS)
    ms = _events_ms(lambda: other.copy_(card), 10)
    out["gpu_local_bw"] = 2 * COPY_BYTES / (ms / 1e3)
    del host, back, card, other
    torch.cuda.empty_cache()
    log(f"pinned host -> card {out['link_bw'] / 1e9:.2f} GB/s, card -> "
        f"pinned host {out['d2h_bw'] / 1e9:.2f} GB/s ({COPY_BYTES} B, "
        f"median of {COPY_REPS}); card -> card copy "
        f"{out['gpu_local_bw'] / 1e9:.1f} GB/s (read + write)")

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(LSMS_N, LSMS_N, generator=gen, dtype=torch.float64,
                    device=dev)
    b = torch.randn(LSMS_N, LSMS_N, generator=gen, dtype=torch.float64,
                    device=dev)
    ms = _events_ms(lambda: gemm.gemm(a, b), 5)
    out["gemm_f64_ms"] = ms
    out["gemm_f64_flops"] = 2.0 * LSMS_N ** 3 / (ms / 1e3)
    del a, b
    torch.cuda.empty_cache()
    log(f"gemm.cu float64 {LSMS_N}^3 (DMMA): {ms:.3f} ms, "
        f"{out['gemm_f64_flops'] / 1e12:.2f} TFLOP/s")

    sa = torch.randn(64, 64, generator=gen, dtype=torch.float64, device=dev)
    calls = 2000
    for _ in range(50):
        gemm.gemm(sa, sa)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        gemm.gemm(sa, sa)
    torch.cuda.synchronize(dev)
    out["launch_s"] = (time.perf_counter() - t0) / calls
    log(f"gemm.gemm 64^3 float64: {out['launch_s'] * 1e6:.2f} us wall per "
        f"call over {calls} back-to-back calls")

    cg = torch.Generator().manual_seed(0)
    ha = torch.randn(HOST_N, HOST_N, generator=cg, dtype=torch.float64)
    hb = torch.randn(HOST_N, HOST_N, generator=cg, dtype=torch.float64)
    s = _median_s(lambda: torch.matmul(ha, hb), 2)
    out["cpu_flops"] = 2.0 * HOST_N ** 3 / s
    tri = torch.tril(ha) / HOST_N + 2.0 * torch.eye(HOST_N,
                                                    dtype=torch.float64)
    rhs = hb[:, :256].contiguous()
    s = _median_s(lambda: torch.linalg.solve_triangular(tri, rhs,
                                                        upper=False), 3)
    out["cpu_trsm_flops"] = 1.0 * HOST_N * HOST_N * 256 / s
    panel = torch.randn(LSMS_N, 256, generator=cg, dtype=torch.float64)
    s = _median_s(lambda: torch.linalg.lu_factor(panel), 3)
    out["cpu_getf2_flops"] = 1.0 * LSMS_N * 256 * 256 / s
    del ha, hb, tri, rhs, panel
    log(f"host float64 (torch {torch.get_num_threads()} threads): matmul "
        f"{HOST_N}^3 {out['cpu_flops'] / 1e9:.1f} GFLOP/s; "
        f"solve_triangular {HOST_N} x 256 "
        f"{out['cpu_trsm_flops'] / 1e9:.1f} GFLOP/s (eff "
        f"{out['cpu_trsm_flops'] / out['cpu_flops']:.3f}); lu_factor "
        f"{LSMS_N} x 256 {out['cpu_getf2_flops'] / 1e9:.1f} GFLOP/s (eff "
        f"{out['cpu_getf2_flops'] / out['cpu_flops']:.3f})")

    ta = torch.empty(TRIAD_N, dtype=torch.float64)
    tb = torch.ones(TRIAD_N, dtype=torch.float64)
    tc = torch.full((TRIAD_N,), 2.0, dtype=torch.float64)
    s = _median_s(lambda: torch.add(tb, tc, alpha=3.0, out=ta), 5)
    out["cpu_local_bw"] = 24.0 * TRIAD_N / s
    na, nb, nc = ta.numpy(), tb.numpy(), tc.numpy()

    def np_triad():
        np.multiply(nc, 3.0, out=na)
        np.add(na, nb, out=na)

    out["numpy_triad_bw"] = 24.0 * TRIAD_N / _median_s(np_triad, 3)
    del ta, tb, tc
    log(f"host triad float64 2^26: torch.add {out['cpu_local_bw'] / 1e9:.1f}"
        f" GB/s; numpy (two passes, one core) "
        f"{out['numpy_triad_bw'] / 1e9:.1f} GB/s (24 B an element)")

    out["host_bytes"] = os.sysconf("SC_PAGE_SIZE") * os.sysconf(
        "SC_PHYS_PAGES")
    out["device_bytes"] = torch.cuda.get_device_properties(dev).total_memory
    log(f"host memory {out['host_bytes']} B; card memory "
        f"{out['device_bytes']} B")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    rates = measure(log=lambda m: print(f"[calibrate] {m}", flush=True))
    rates["card"] = card_line()
    line = json.dumps(rates)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
