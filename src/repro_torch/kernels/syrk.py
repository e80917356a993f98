"""C = op(A) op(A)^T, one triangle, on the hand-written Hopper kernel
(``csrc/syrk.cu``).

The counterpart of ``repro/kernels/syrk.py`` (the Pallas ``syrk``).  A
CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, :func:`syrk_plain`, which the CPU tests use and the chip check
compares the kernel with.  Only the ``uplo`` triangle is computed; the
other one is zero, as the reference returns it.  With ``trans="T"`` the
kernel reads a k x n row-major ``a`` transposed in its loads, so a tall
panel goes in uncopied.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import compat, ref
from repro_torch.kernels.gemm import CODES, row_major

#: launches of the CUDA kernel since the last reset
launches = 0

_c_ll = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, _c_ll, _c_ll, ctypes.c_int, _c_ll, _c_ll,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
    global launches
    launches += 1
    rc = _entry()(CODES[a.dtype], a.data_ptr(), out.data_ptr(), n, k,
                  a3.stride(1), c3.stride(1), batch, a3.stride(0),
                  c3.stride(0), int(trans == "T"), int(uplo == "L"),
                  torch.cuda.current_stream(a.device).cuda_stream)
    compat.check(rc, "syrk")
    return out
