"""Builder and loader for the port's hand-written CUDA kernels.

The counterpart of ``repro/kernels/compat.py``, which exported Pallas or
``None`` so that a missing Pallas degraded to the XLA reference.  The
port does not degrade: a kernel that cannot be built raises.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with :mod:`ctypes`.  Libraries live under
``build/kernels/`` at the root of the checkout, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so a second
process reuses them and an edited header rebuilds every library.
Nothing is built when a module is imported: the first launch asks for
its library, and that request compiles every source at once, one
``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: what the last build printed per source (ptxas registers, spills, ...)
BUILD_LOG: Dict[str, str] = {}
#: wall seconds of the last build that compiled anything (0 when cached)
BUILD_SECONDS = 0.0

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: guards the wrappers' launch counters (``gemm.launches`` and the
#: rest), which worker threads of one process update concurrently
COUNT_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """A kernel source did not build (``nvcc`` failed or is missing).
    An error of the port, not of the device: the runtime's fault guards
    never absorb it (``repro_torch.core.faults.classify``)."""


class KernelLaunchError(RuntimeError):
    """A launch entry point returned a CUDA error, or could not make its
    TMA descriptors.  Never absorbed by the fault guards either."""


def nvcc() -> str:
    """Path of the CUDA compiler, or raise."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand is not None and cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME): the port's "
                               "CUDA kernels cannot be built on this "
                               "machine")
    return found


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def headers() -> Dict[str, Path]:
    return {p.name: p for p in sorted(CSRC.glob("*.cuh"))}


def library_path(name: str) -> Path:
    h = hashlib.sha256(sources()[name].read_bytes())
    for path in headers().values():
        h.update(path.name.encode() + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Raises :class:`KernelBuildError` with the compiler's output when one
    fails."""
    global BUILD_SECONDS
    targets = {name: library_path(name) for name in sources()}
    todo = {n: p for n, p in targets.items() if not p.is_file()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode == 0:
            os.replace(tmp, path)      # atomic: a racing build sees old or new
        else:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
    BUILD_SECONDS = time.perf_counter() - t0
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
    return lib


def kernel_name(mangled: str) -> str:
    """A kernel's readable name from its mangled one, e.g.
    ``dmma_f64_kernel<Li128ELb0ELb1>``: the name and its template
    arguments (still mangled), without the anonymous namespace's hash,
    which differs between two builds of the same source."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if m:
        end = m.end() + int(m.group(1))
        args = re.match(r"I(\w+?)E+v", mangled[end:])
        base = mangled[m.end():end]
        return f"{base}<{args.group(1)}>" if args else base
    t = re.search(r"\d*([a-z][a-z0-9_]*_kernel)I(\w+?)E+v", mangled)
    return f"{t.group(1)}<{t.group(2)}>" if t else mangled


def ptxas_variants(log: str) -> list:
    """Per entry function of one source's ``ptxas -v`` log (BUILD_LOG):
    its name (:func:`kernel_name`), registers, static shared memory, stack
    and spill bytes, and how many 256-thread blocks an H100 SM holds by
    registers, static shared memory and threads (65536 registers allocated
    8 per thread at a time, 228 KiB of shared memory with 1 KiB reserved
    per block, 2048 threads)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = dict(name=kernel_name(m.group(1)), stack=0, spill=0)
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


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero status returned by a launch entry point: a
    refused dtype or shape as ``TypeError``/``ValueError`` (a bug of the
    caller), a failed descriptor or launch as :class:`KernelLaunchError`."""
    if rc == 0:
        return
    if rc == -1:
        raise TypeError(f"{kernel}: dtype combination not supported")
    if rc == -2:
        raise ValueError(f"{kernel}: shape cannot be launched")
    if rc == -3:
        raise KernelLaunchError(f"{kernel}: TMA descriptors could not be "
                                f"made")
    raise KernelLaunchError(f"{kernel}: launch failed with cudaError {rc}")
