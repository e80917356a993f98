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

import collections
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, MutableMapping, Sequence

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

#: per thread: the record of the stream capture under way, else None
_CAPTURE = threading.local()
#: the stream captures under way that other threads may launch into
#: (autograd's device thread runs a captured backward on the capture's
#: stream): the stream's handle -> the capture's record
_BY_STREAM: Dict[int, List] = {}


def _stream_record():
    """The record of the capture under way on this thread's current CUDA
    stream, if another thread registered it (:func:`recording`)."""
    import torch
    if not torch.cuda.is_current_stream_capturing():
        return None
    return _BY_STREAM.get(torch.cuda.current_stream().cuda_stream)


def count(counters: MutableMapping[str, int], **moves: int) -> None:
    """Add ``moves`` to the named launch counters of ``counters`` (a
    kernel module's ``globals()``, or a dict of counters such as
    ``attention.launches_by_path``) under :data:`COUNT_LOCK`.  While this
    thread captures a CUDA graph (:func:`recording`), or launches into the
    stream that another thread captures, nothing launches, so the moves
    go into the capture's record instead, and every replay of the graph
    adds them (:func:`replayed`)."""
    record = getattr(_CAPTURE, "record", None)
    if record is None and _BY_STREAM:
        record = _stream_record()
    if record is not None:
        record.append((counters, moves))
        return
    with COUNT_LOCK:
        for name, n in moves.items():
            counters[name] += n


def _current_stream_key():
    """The handle of this thread's current CUDA stream, or None where
    CUDA has not been initialized (nothing can be captured there)."""
    import torch
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream().cuda_stream


@contextlib.contextmanager
def recording() -> Iterator[List]:
    """Collect this thread's counter moves for the block's duration, a
    stream capture's: yields the record that :func:`replayed` adds once
    per replay.  The block's current CUDA stream is the one captured:
    another thread that launches into it while it captures (autograd's
    device thread runs a captured backward there) files its moves in
    the record too.  Other threads keep counting their own launches."""
    prev = getattr(_CAPTURE, "record", None)
    _CAPTURE.record = record = []
    key = _current_stream_key()
    if key is not None:
        with COUNT_LOCK:
            outer = _BY_STREAM.get(key)
            _BY_STREAM[key] = record
    try:
        yield record
    finally:
        _CAPTURE.record = prev
        if key is not None:
            with COUNT_LOCK:
                if outer is None:
                    _BY_STREAM.pop(key, None)
                else:
                    _BY_STREAM[key] = outer


def replayed(record: List) -> None:
    """Count one replay of a captured graph: every move of its record,
    under :data:`COUNT_LOCK`."""
    with COUNT_LOCK:
        for counters, moves in record:
            for name, n in moves.items():
                counters[name] += n


#: the collectives that captured steps issued, by op name: each replay
#: adds what ``CommDebugMode`` saw in its capture (:func:`capture`), the
#: one place a Python-level count of a replay's collectives exists
collectives: Dict[str, int] = collections.defaultdict(int)


def capture(fn: Callable, *args, stream, generators: Sequence = ()):
    """Capture ``fn(*args)`` in one ``torch.cuda.CUDAGraph`` on ``stream``
    (a side stream that waits for the current one), in this thread's own
    capture mode (``thread_local``: other threads keep launching, and may
    capture steps of their own).  ``generators`` are registered with the
    graph, so that a replay draws afresh.  Nothing runs until the first
    replay.  The launch counters' moves go into the capture's record
    (:func:`recording`); under an initialized process group the
    collectives ``CommDebugMode`` sees go there too, as moves of
    :data:`collectives`.  A capture that fails raises.  Returns (graph,
    ``fn``'s outputs, the record)."""
    import torch
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    comm = None
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        from torch.distributed.tensor.debug import CommDebugMode
        comm = CommDebugMode()
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream), recording() as record, \
            (comm or contextlib.nullcontext()):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn(*args)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass        # the capture was already invalidated
            raise
        graph.capture_end()
    current.wait_stream(stream)
    if comm is not None and comm.get_total_counts():
        record.append((collectives, {str(op).split(".")[-1]: n for op, n
                                     in comm.get_comm_counts().items()}))
    return graph, out, record


def _leaves(tree) -> list:
    from repro_torch.tree import leaves
    return leaves(tree)


class GraphedStep:
    """A step function run on the card as ``jax.jit`` runs one: the first
    call runs ``step`` eagerly on a side stream (the warm-up: it loads the
    kernels, makes the process group's communicators and fills DTensor's
    sharding caches; a real step), the second captures it in one CUDA
    graph (:func:`capture`) and replays the capture, every later call
    replays it.  The mesh path's decode step is the one such step that
    no object of its own captures (``Server`` and ``Trainer`` capture
    theirs through :func:`capture`).

    ``step``'s arguments are trees of tensors (and host values, which
    must not change after the capture).  The arguments at the indices
    ``fresh`` are tensors that are new every call (an input token): the
    capture takes copies of them, and every replay copies the call's
    values in.  Every other argument is the graph's own (parameters, a
    cache the step writes in place, the one-element position tensor the
    caller fills): a call passes the very tensors the capture saw, or
    tensors of their shapes, which are copied in.  A call returns ``step``'s outputs, on a
    replay the graph's own output tensors, rewritten by the next replay.
    Each replay adds the capture's record to the launch counters and to
    :data:`collectives`.  Nothing in a replay reads the host."""

    def __init__(self, step: Callable, device=None,
                 fresh: Sequence[int] = ()):
        import torch
        self.step = step
        self.device = torch.device("cuda" if device is None else device)
        self.fresh = tuple(fresh)
        self.stream = None
        self.graph = None
        self.args: tuple = ()
        self.out = None
        self.record: List = []
        self.replays = 0

    def __call__(self, *args):
        import torch
        current = torch.cuda.current_stream(self.device)
        if self.stream is None:             # the warm-up
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                out = self.step(*args)
            current.wait_stream(self.stream)
            return out
        if self.graph is None:
            self.args = tuple(a.clone() if i in self.fresh else a
                              for i, a in enumerate(args))
            self.graph, self.out, self.record = capture(
                self.step, *self.args, stream=self.stream)
        self._copy_in(args)
        self.graph.replay()
        replayed(self.record)
        self.replays += 1
        return self.out

    def release(self) -> None:
        """Free the graph and the buffers it holds.  Call it before the
        process group whose collectives it captured is destroyed: NCCL
        keeps a communicator until the graphs that captured it are
        gone."""
        if self.graph is not None:
            self.graph.reset()
        self.graph, self.stream, self.args, self.out = None, None, (), None
        self.record = []

    def _copy_in(self, args) -> None:
        import torch
        if len(args) != len(self.args):
            raise ValueError(f"GraphedStep: {len(args)} arguments, the "
                             f"capture took {len(self.args)}")
        for i, (new, old) in enumerate(zip(args, self.args)):
            src, dst = _leaves(new), _leaves(old)
            if len(src) != len(dst):
                raise ValueError(f"GraphedStep: argument {i} has another "
                                 f"structure than at the capture")
            for s, d in zip(src, dst):
                if s is d:
                    continue
                if not isinstance(d, torch.Tensor):
                    if s != d:
                        raise ValueError(f"GraphedStep: argument {i} holds "
                                         f"{s!r}, the capture saw {d!r}")
                    continue
                if (s.shape, s.dtype) != (d.shape, d.dtype):
                    raise ValueError(
                        f"GraphedStep: argument {i} has a tensor "
                        f"{tuple(s.shape)} {s.dtype} where the capture "
                        f"had {tuple(d.shape)} {d.dtype}")
                d.copy_(s)


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
