"""Split-precision fp64 GEMM for the `pallas` dispatch venue.

The counterpart of ``repro/kernels/split_gemm.py``.
:mod:`repro_torch.core.precision` owns the decomposition math (slices,
cross passes, error bounds).  On CUDA tensors the whole split product
runs in the fused kernel ``csrc/split_gemm.cu``: fp64 operands in, the
slices made in the kernel, every cross pass an IEEE fp32 product per
256-column chunk, fp64 re-accumulation, in two launches (the passes, then
a fixed-order sum of the K-split partials).  It computes what
``precision.matmul(a, b, scheme, mm=pass_mm())`` computes, the plain
version, which a CPU tensor takes: the same passes on the gemm kernel's
plain float32 product, so the venue's split path runs in the CPU tests
too.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import precision
from repro_torch.kernels import compat, gemm

#: launches of the fused split kernel (CUDA tensors) since the last
#: reset: 2 per product
launches = 0

#: blocks the pass kernel aims for before splitting K (4 per SM of 132);
#: its output tile is 32 x 128
TARGET_BLOCKS = 4 * 132
TILE_M, TILE_N = 32, 128

_c_ll = ctypes.c_longlong
_GEMM_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              _c_ll, _c_ll, _c_ll, _c_ll, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]
_SLICE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, _c_ll, ctypes.c_void_p]
_SCHEMES = {"split2": 2, "split3": 3}


def reset_launches() -> None:
    global launches
    launches = 0


def _fn(name: str, argtypes):
    fn = getattr(compat.library("split_gemm"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One fp32 slice product on the gemm kernel (its plain version on
    CPU tensors), written in float32; an empty contraction (k = 0) is
    zeros."""
    if a.shape[-1] == 0:
        return torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                           device=a.device)
    return gemm.gemm(a, b, out_dtype=torch.float32)


def pass_mm() -> precision.MatMul:
    """The fp32 slice-product primitive of the plain version."""
    return _mm


def splits_for(m: int, n: int, k: int) -> int:
    """How many ways the pass kernel splits K (at 256-column chunks) so
    that the output tiles fill the card."""
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    chunks = -(-k // precision.SPLIT3_CHUNK)
    return max(1, min(chunks, TARGET_BLOCKS // tiles))


def fused(a: torch.Tensor, b: torch.Tensor, scheme: str, *,
          drop: Tuple[Tuple[int, int], ...] = ()) -> torch.Tensor:
    """fp64 ``a @ b`` in the fused kernel: 2-D CUDA operands of any
    strides.  ``drop`` leaves those cross passes of
    ``precision._PASSES[scheme]`` out of the sum: a negative control for
    the exact-pass check, never used by the venue."""
    if a.device.type != "cuda":
        raise ValueError(f"split_gemm.fused: CUDA operands, got {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"split_gemm: 2-D operands that multiply, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError(f"split_gemm: float64 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"split_gemm: operands on {a.device} and "
                         f"{b.device}")
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown split scheme: {scheme!r}")
    passes = precision._PASSES[scheme]
    if not set(drop) <= set(passes):
        raise ValueError(f"split_gemm: {scheme} has no passes {drop}")
    mask = sum(1 << q for q, p in enumerate(passes) if p not in drop)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float64, device=a.device)
    if out.numel() == 0:
        return out
    splits = splits_for(m, n, k)
    work = torch.empty(2 * splits * m * n, dtype=torch.float64,
                       device=a.device)
    compat.count(globals(), launches=2)
    rc = _fn("repro_split_gemm", _GEMM_ARGS)(
        _SCHEMES[scheme], a.data_ptr(), b.data_ptr(), out.data_ptr(),
        work.data_ptr(), m, n, k, a.stride(0), a.stride(1), b.stride(0),
        b.stride(1), splits, mask,
        torch.cuda.current_stream(a.device).cuda_stream)
    compat.check(rc, "split_gemm")
    return out


def slices(x: torch.Tensor, scheme: str):
    """The slices the fused kernel makes of ``x`` (fp32, each shaped like
    ``x``), written by the kernel's own slicing code: on the card they
    must equal :func:`precision.slices` bit for bit.  CPU tensors take
    ``precision.slices`` itself."""
    if x.device.type == "cpu":
        return precision.slices(x, scheme)
    if x.dtype != torch.float64 or scheme not in _SCHEMES:
        raise TypeError(f"split_gemm.slices: float64 and a split scheme, "
                        f"got {x.dtype} and {scheme!r}")
    xc = x.contiguous()
    outs = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
            for _ in range(_SCHEMES[scheme])]
    tail = outs[2].data_ptr() if scheme == "split3" else None
    rc = _fn("repro_split_slices", _SLICE_ARGS)(
        xc.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), tail,
        xc.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    compat.check(rc, "split_gemm.slices")
    return tuple(outs)


def matmul(a: torch.Tensor, b: torch.Tensor, scheme: str) -> torch.Tensor:
    """fp64 ``A @ B`` via split slices: the fused kernel on CUDA tensors,
    the plain passes (:func:`precision.matmul`) on CPU tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return precision.matmul(a, b, scheme, mm=pass_mm())
    return fused(a, b, scheme)


def syrk(a: torch.Tensor, scheme: str, *, trans: bool = False
         ) -> torch.Tensor:
    """``a @ a.T`` (or ``a.T @ a``) as :func:`precision.syrk` computes
    it, through :func:`matmul`."""
    at = a.mT
    return matmul(at, a, scheme) if trans else matmul(a, at, scheme)


def trsm(a: torch.Tensor, b: torch.Tensor, scheme: str, *,
         left_side: bool = True, lower: bool = True, trans_a: bool = False,
         unit_diag: bool = False) -> torch.Tensor:
    """:func:`precision.trsm` with its refinement product on
    :func:`matmul`."""
    return precision.trsm(a, b, scheme, left_side=left_side, lower=lower,
                          trans_a=trans_a, unit_diag=unit_diag,
                          product=matmul)
