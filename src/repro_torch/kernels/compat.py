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


def nvcc() -> str:
    """Path of the CUDA compiler, or raise."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand is not None and cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "CUDA kernels cannot be built on this machine")
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
    Raises ``RuntimeError`` with the compiler's output when one fails."""
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
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
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


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero status returned by a launch entry point."""
    if rc == 0:
        return
    if rc == -1:
        raise TypeError(f"{kernel}: dtype combination not supported")
    if rc == -2:
        raise ValueError(f"{kernel}: shape cannot be launched")
    if rc == -3:
        raise RuntimeError(f"{kernel}: TMA descriptors could not be made")
    raise RuntimeError(f"{kernel}: launch failed with cudaError {rc}")
