"""C = op(A) op(A)^T, one triangle, on the hand-written Hopper kernel
(``csrc/syrk.cu``).

The counterpart of ``repro/kernels/syrk.py`` (the Pallas ``syrk``).  A
CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, :func:`syrk_plain`, which the CPU tests use and the chip check
compares the kernel with.  Only the ``uplo`` triangle is computed; the
other one is zero, as the reference returns it.  With ``trans="T"`` the
kernel reads a k x n row-major ``a`` transposed in its loads, so a tall
panel goes in uncopied.

float64 runs 128 x 128 tiles on the DMMA tensor cores with K split across
blocks as :func:`plan` says, each range's partial tile summed in split
order by a second, small launch (:func:`syrk_split_plain` is that order
in plain PyTorch); the launch counter counts one per call.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import compat, ref
from repro_torch.kernels.gemm import CODES, row_major

#: calls that launched the CUDA kernel since the last reset
launches = 0

#: streaming multiprocessors of an H100 SXM
SMS = 132
#: the float64 kernel's tile edge and K tile; one 216 KB block per SM
DMMA_EDGE, DMMA_BK, DMMA_PER_SM = 128, 32, 1
#: the FMA kernel's (float32, bfloat16, float16) tile edge; 256 threads, so
#: at most 8 blocks per SM
FMA_EDGE, FMA_PER_SM = 64, 8
#: the fill of the last wave a split must reach; the fewest K tiles a range
#: keeps: a range's partial tile is written and read back once (2 x 128^2
#: x 8 bytes) against its 2 x 128^2 x 32 x 128 operations, about 4% of the
#: block's DMMA time at each SM's share of the card's rates; the most ranges
LAST_WAVE_FILL = 0.9
MIN_SPLIT_TILES = 128
MAX_SPLITS = 64

_c_ll = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, _c_ll, _c_ll, ctypes.c_int, _c_ll, _c_ll,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


class Plan(NamedTuple):
    edge: int       # tile edge of C
    tiles: int      # on-triangle tiles per matrix
    splits: int     # K ranges, each a block per tile
    chunk: int      # K per range (the last may hold less), a multiple of 32
    waves: float    # blocks / (SMs x blocks per SM), per matrix

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def ranges(self, k: int):
        """The K range [lo, hi) of each split, in split order."""
        return [(s * self.chunk, min(k, (s + 1) * self.chunk))
                for s in range(self.splits)]


def _tiles(n: int, edge: int) -> int:
    nt = -(-n // edge)
    return nt * (nt + 1) // 2


def plan(n: int, k: int, dtype: torch.dtype = torch.float64,
         trans: str = "N") -> Plan:
    """How the kernel covers C = op(A) op(A)^T with op(A) n x k.  float64
    (DMMA, one block per SM): the fewest K ranges, each a whole number of
    32-deep K tiles and at least MIN_SPLIT_TILES of them, whose blocks
    leave the last wave at least LAST_WAVE_FILL full; where no count up to
    MAX_SPLITS does, the count with the least idle share of its waves
    (the fewest on a tie).  The other types walk all of K in one block per
    64 x 64 tile.  ``trans`` does not change the plan: both layouts stage
    the same tiles."""
    if trans not in ("N", "T"):
        raise ValueError(f"syrk.plan: trans {trans!r}; N or T")
    if dtype != torch.float64:
        tiles = _tiles(n, FMA_EDGE)
        return Plan(FMA_EDGE, tiles, 1, k, tiles / (SMS * FMA_PER_SM))
    tiles = _tiles(n, DMMA_EDGE)
    slots = SMS * DMMA_PER_SM
    kt = -(-k // DMMA_BK)
    best = None                  # (busy share of the waves, splits, chunk)
    for want in range(1, max(1, min(MAX_SPLITS, kt // MIN_SPLIT_TILES)) + 1):
        chunk = -(-kt // want) * DMMA_BK
        splits = -(-k // chunk) if k else 1
        blocks = tiles * splits
        if (blocks % slots or slots) >= LAST_WAVE_FILL * slots:
            best = (1.0, splits, chunk)
            break
        busy = blocks / (-(-blocks // slots) * slots)
        if best is None or busy > best[0]:
            best = (busy, splits, chunk)
    _, splits, chunk = best
    if splits == 1:
        chunk = k
    return Plan(DMMA_EDGE, tiles, splits, chunk, tiles * splits / slots)


def reset_launches() -> None:
    global launches
    launches = 0


def _entry():
    fn = compat.library("syrk").repro_syrk
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def syrk_plain(a: torch.Tensor, *, uplo: str = "L",
               trans: str = "N") -> torch.Tensor:
    """The plain PyTorch version of the kernel: the full product with the
    same accumulation rule, masked to the ``uplo`` triangle."""
    return ref.syrk(a, uplo=uplo, trans=trans)


def syrk_split_plain(a: torch.Tensor, *, uplo: str = "L",
                     trans: str = "N") -> torch.Tensor:
    """The float64 kernel's summation order in plain PyTorch: one partial
    product per K range of :func:`plan`, the partials summed in split
    order, then masked to the ``uplo`` triangle."""
    opa = a if trans == "N" else a.mT
    n, k = opa.shape[-2], opa.shape[-1]
    p = plan(n, k, a.dtype, trans)
    out = None
    for lo, hi in p.ranges(k):
        part = ref.matmul(opa[..., lo:hi], opa[..., lo:hi].mT)
        out = part if out is None else out + part
    if out is None:
        out = ref.matmul(opa, opa.mT)
    return out.tril() if uplo == "L" else out.triu()


def syrk(a: torch.Tensor, *, uplo: str = "L",
         trans: str = "N") -> torch.Tensor:
    """C = op(A) op(A)^T on the ``uplo`` triangle, zeros elsewhere.
    ``a`` is [n, k] (``trans="N"``) or [k, n] (``trans="T"``), optionally
    with one leading batch dimension, with a unit column stride and any
    row stride.  The output has the input's dtype."""
    if a.device.type == "cpu":
        return syrk_plain(a, uplo=uplo, trans=trans)
    if a.device.type != "cuda":
        raise ValueError(f"syrk: operand on {a.device}; it must be on a "
                         f"CUDA device")
    if a.dtype not in CODES:
        raise TypeError(f"syrk: kernel takes float32, float64, bfloat16 or "
                        f"float16, got {a.dtype}")
    if uplo not in ("L", "U") or trans not in ("N", "T"):
        raise ValueError(f"syrk: uplo {uplo!r} / trans {trans!r}; the "
                         f"kernel takes L/U and N/T")
    if a.dim() not in (2, 3):
        raise ValueError(f"syrk: A must be 2-D or 3-D (batched), got "
                         f"shape {tuple(a.shape)}")
    if not row_major(a):
        raise ValueError(f"syrk: A needs a unit column stride and "
                         f"non-overlapping rows (strides {a.stride()}); "
                         f"pass .contiguous()")
    n, k = ((a.shape[-2], a.shape[-1]) if trans == "N"
            else (a.shape[-1], a.shape[-2]))
    batched = a.dim() == 3
    batch = a.shape[0] if batched else 1
    out = torch.zeros((batch, n, n) if batched else (n, n), dtype=a.dtype,
                      device=a.device)
    if out.numel() == 0:
        return out
    a3 = a if batched else a.unsqueeze(0)
    c3 = out if batched else out.unsqueeze(0)
    p = plan(n, k, a.dtype, trans)
    work = (torch.empty(batch * p.blocks * p.edge * p.edge,
                        dtype=torch.float64, device=a.device)
            if p.splits > 1 else None)
    compat.count(globals(), launches=1)
    rc = _entry()(CODES[a.dtype], a.data_ptr(), out.data_ptr(), n, k,
                  a3.stride(1), c3.stride(1), batch, a3.stride(0),
                  c3.stride(0), int(trans == "T"), int(uplo == "L"),
                  p.splits, p.chunk,
                  work.data_ptr() if work is not None else None,
                  torch.cuda.current_stream(a.device).cuda_stream)
    compat.check(rc, "syrk")
    return out
