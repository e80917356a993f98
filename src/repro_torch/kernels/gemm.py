"""C = A @ B on the hand-written Hopper kernel (``csrc/gemm.cu``).

The counterpart of ``repro/kernels/gemm.py`` (the Pallas ``gemm``).  A
CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, :func:`gemm_plain`, which the CPU tests use and the chip check
compares the kernel with.  The kernel masks ragged edges itself, so the
wrapper neither pads nor crops.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import compat, ref

#: launches of the CUDA kernel since the last reset
launches = 0

#: dtype codes of csrc/gemm.cu (also csrc/trsm.cu for the first two)
CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
         torch.float16: 3}
#: output dtypes the kernel writes for each input dtype
OUT_DTYPES = {torch.float32: (torch.float32,),
              torch.float64: (torch.float64,),
              torch.bfloat16: (torch.bfloat16, torch.float32),
              torch.float16: (torch.float16, torch.float32)}

_c_ll = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _c_ll, _c_ll, _c_ll, ctypes.c_int, _c_ll, _c_ll, _c_ll,
             ctypes.c_void_p]


def reset_launches() -> None:
    global launches
    launches = 0


def _entry():
    fn = compat.library("gemm").repro_gemm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def gemm_plain(a: torch.Tensor, b: torch.Tensor, *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same product with the
    same accumulation rule (f32 for bf16/f16/f32, f64 for f64)."""
    return ref.matmul(a, b, out_dtype)


def row_major(x: torch.Tensor) -> bool:
    """The layout both kernels read: a unit column stride and rows that
    do not overlap (any row stride, so views of a larger matrix go in
    uncopied)."""
    return ((x.shape[-1] <= 1 or x.stride(-1) == 1)
            and (x.shape[-2] <= 1 or x.stride(-2) >= x.shape[-1]))


def _check_matrix(x: torch.Tensor, name: str) -> None:
    if x.dim() not in (2, 3):
        raise ValueError(f"gemm: {name} must be 2-D or 3-D (batched), "
                         f"got shape {tuple(x.shape)}")
    if not row_major(x):
        raise ValueError(f"gemm: {name} needs a unit column stride and "
                         f"non-overlapping rows (strides {x.stride()}); "
                         f"pass .contiguous()")


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B.  ``a`` is [M, K] or [batch, M, K], ``b`` [K, N] or
    [batch, K, N] (both 2-D or both 3-D), each with a unit column stride
    and any row stride, so views of a larger matrix go in uncopied.
    ``out_dtype`` defaults to the input dtype."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_plain(a, b, out_dtype=out_dtype)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"gemm: operands on {a.device} and {b.device}; "
                         f"both must be on one CUDA device")
    if a.dtype != b.dtype or a.dtype not in CODES:
        raise TypeError(f"gemm: kernel takes matching float32, float64, "
                        f"bfloat16 or float16 operands, got {a.dtype} and "
                        f"{b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in OUT_DTYPES[a.dtype]:
        raise TypeError(f"gemm: {a.dtype} inputs cannot write {out_dtype}")
    _check_matrix(a, "A")
    _check_matrix(b, "B")
    if a.dim() != b.dim() or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    batched = a.dim() == 3
    if batched and a.shape[0] != b.shape[0]:
        raise ValueError(f"gemm: batch sizes {a.shape[0]} and {b.shape[0]}")
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    batch = a.shape[0] if batched else 1
    out = torch.empty((batch, m, n) if batched else (m, n),
                      dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    c3 = out if batched else out.unsqueeze(0)
    a3 = a if batched else a.unsqueeze(0)
    b3 = b if batched else b.unsqueeze(0)
    global launches
    launches += 1
    rc = _entry()(CODES[a.dtype], CODES[out_dtype], a.data_ptr(),
                  b.data_ptr(), out.data_ptr(), m, n, k,
                  a3.stride(1), b3.stride(1), c3.stride(1), batch,
                  a3.stride(0), b3.stride(0), c3.stride(0),
                  torch.cuda.current_stream(a.device).cuda_stream)
    compat.check(rc, "gemm")
    return out
