"""Stress probe of the flash kernel's wgmma path, at two register caps.

Builds ``csrc/flash_attention.cu`` twice with its trap record on
(``-DREPRO_TRAP_RECORD``): once with the consumers' ``setmaxnreg`` cap at
240, the committed value, and once at 232.  Each build then runs in a
process of its own at gemma2-9b's serve shape (bf16 q [2,16,4608,256], k
and v [2,8,4608,256], causal, softcap 50, q scaled by 30 so that the cap
bites), ``--reps`` calls per window (0 and 4096).  Every output is
compared bit for bit with the first (the kernel's arithmetic order is
fixed, so a race in its barrier protocol shows as a difference) and the
first per query row with the plain version.  A launch that fails reads
the trap record from host memory: the block, thread and mbarrier of the
first wait that ran out of spins, or none, when the fault was another.

    PYTHONPATH=src python -m repro_torch.launch.flash_probe [--reps 300]

Needs a CUDA card and ``nvcc``.  Prints per variant its ptxas registers
and spills for the D = 256 kernels, then one JSON line with the result;
exits 1 when a variant failed.  The libraries go to ``build/probe/``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

#: consumer register caps to probe, the committed one first
CAPS = (240, 232)
#: the trap record's marker (csrc/hopper.cuh)
TRAPPED = 0x7A11


def build(caps) -> dict:
    """One library per cap, compiled in parallel; returns cap -> (path,
    the D = 256 wgmma kernels' ptxas lines)."""
    from repro_torch.kernels import compat
    out_dir = compat.BUILD_DIR.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = compat.sources()["flash_attention"]
    procs = {}
    for cap in caps:
        lib = out_dir / f"libflash_attention-trap-{cap}.so"
        cmd = [compat.nvcc(), *compat.NVCC_FLAGS, "-DREPRO_TRAP_RECORD",
               f"-DFLASH_CONSUMER_REGS={cap}", "-o", str(lib), str(src)]
        procs[cap] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for cap, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe build (cap {cap}) failed:\n{log}")
        built[cap] = (lib, d256_lines(log))
    return built


def d256_lines(ptxas_log: str) -> list:
    """The spill and register lines of the D = 256 wgmma kernels."""
    out, cur = [], None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1) if "flash_wgmma_kernel" in m.group(1) \
                and "Li256E" in m.group(1) else None
        elif cur is not None and ("stack frame" in ln or "registers" in ln):
            out.append(ln.strip())
    return out


def run_variant(lib_path: str, reps: int) -> dict:
    """In this process: load ``lib_path`` as the flash library, point its
    trap record at pinned host memory, and run the serve shape."""
    import ctypes
    import torch
    from repro_torch.kernels import attention, compat
    lib = ctypes.CDLL(lib_path)
    compat._LIBS["flash_attention"] = lib
    dev = torch.device("cuda:0")
    record = torch.zeros(8, dtype=torch.int32, pin_memory=True)
    rc = lib.repro_set_trap_record(ctypes.c_void_p(record.data_ptr()))
    if rc != 0:
        raise RuntimeError(f"trap record not set: cudaError {rc}")
    view = (ctypes.c_uint * 8).from_address(record.data_ptr())
    gen = torch.Generator(device=dev).manual_seed(3)
    b, hq, hkv, t, d = 2, 16, 8, 4608, 256
    q, k, v = (torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
               for shape in ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d)))
    q = q * 30.0
    result = {"lib": Path(lib_path).name, "reps": reps, "windows": {}}
    try:
        for window in (0, 4096):
            kw = dict(causal=True, softcap=50.0, window=window)
            first = attention.flash_attention(q, k, v, **kw)
            want = attention.flash_attention_plain(q, k, v, **kw).float()
            g = first.float()
            den = want.abs().amax(-1).clamp_min(1e-30)
            row_err = ((g - want).abs().amax(-1) / den).max().item()
            differ = 0
            t0 = time.perf_counter()
            for _ in range(reps):
                got = attention.flash_attention(q, k, v, **kw)
                differ += int(not torch.equal(got, first))
            torch.cuda.synchronize()
            result["windows"][window] = dict(
                row_err=row_err, reps_differing=differ,
                wall_ms_per_call=(time.perf_counter() - t0) / reps * 1e3)
        result["ok"] = all(w["reps_differing"] == 0 and w["row_err"] <= 1e-2
                           for w in result["windows"].values())
    except Exception as exc:   # the fault is the finding: report it
        result["ok"] = False
        result["error"] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    if view[0] == TRAPPED:
        result["trap"] = dict(block=view[1], thread=view[2],
                              role=("producer" if view[2] >= 256
                                    else f"consumer {view[2] // 128}"),
                              barrier_smem_addr=view[3],
                              barrier_index=(view[3] % 1024) // 8,
                              parity=view[4])
    else:
        result["trap"] = None
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--run", help="(internal) run one built library")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.run:
        print(json.dumps(run_variant(args.run, args.reps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA card", file=sys.stderr)
        return 2
    failed = False
    for cap, (lib, lines) in build(CAPS).items():
        for ln in lines:
            print(f"[probe] cap {cap}: {ln}", flush=True)
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.flash_probe",
                 "--run", str(lib), "--reps", str(args.reps)],
                capture_output=True, text=True, timeout=args.timeout)
            lines_out = [ln for ln in proc.stdout.splitlines()
                         if ln.startswith("{")]
            res = (json.loads(lines_out[-1]) if lines_out else
                   {"ok": False, "error": f"exit {proc.returncode}: "
                                          f"{proc.stderr[-600:]}"})
        except subprocess.TimeoutExpired:
            res = {"ok": False, "error": f"timeout after {args.timeout} s"}
        res["consumer_regs"] = cap
        failed |= not res["ok"]
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
