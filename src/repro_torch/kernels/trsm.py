"""Triangular solve: a recursion over the hand-written base kernel
(``csrc/trsm.cu``) and the port's gemm kernel.

The counterpart of ``repro/kernels/trsm.py``.  A large lower-left solve
splits at a power of two,

    [A11  0 ] [X1]   [B1]      X1 = solve(A11, B1)
    [A21 A22] [X2] = [B2]  =>  X2 = solve(A22, B2 - A21 @ X1)

so almost all operations are the ``A21 @ X1`` updates on the gemm kernel,
and only diagonal blocks of at most :data:`BASE` rows reach the
substitution kernel.  All eight (side, uplo, trans) variants reduce to
lower-left-N by transposition, conjugation and index reversal
(:func:`trsm`).  Batched calls run the same recursion on [batch, m, m]
tensors: both kernels take a batch grid dimension, so there is no loop.

On a CUDA tensor :func:`trsm_base` launches the kernel or raises; on a
CPU tensor it takes :func:`trsm_base_plain`, the same substitution in
plain PyTorch, and the gemm update takes its plain version the same way.
Real float32 and float64 only: complex solves stay on the library
(``kernels/ops.py``), as in the reference.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from repro_torch.kernels import compat
from repro_torch.kernels.gemm import CODES, gemm, gemm_plain, row_major

#: largest diagonal block the substitution kernel takes
BASE = 128

#: launches of the CUDA base kernel since the last reset
launches = 0

_c_ll = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _c_ll, _c_ll,
             _c_ll, ctypes.c_int, _c_ll, _c_ll, _c_ll, ctypes.c_int,
             ctypes.c_void_p]
_DTYPES = (torch.float32, torch.float64)


def reset_launches() -> None:
    global launches
    launches = 0


def _entry():
    fn = compat.library("trsm").repro_trsm_base
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def trsm_base_plain(l: torch.Tensor, b: torch.Tensor, *,
                    unit: bool) -> torch.Tensor:
    """The plain PyTorch version of the base kernel, step for step: row
    i of X is finished, then L[r, i] * X[i] leaves every row r below."""
    x = b.clone()
    for i in range(l.shape[-1]):
        if not unit:
            x[..., i, :] = x[..., i, :] / l[..., i, i, None]
        x[..., i + 1:, :] -= l[..., i + 1:, i, None] * x[..., i, None, :]
    return x


def trsm_base(l: torch.Tensor, b: torch.Tensor, *,
              unit: bool) -> torch.Tensor:
    """X = L^-1 B for one lower block of at most :data:`BASE` rows; ``l``
    is [nb, nb] or [batch, nb, nb], ``b`` [nb, n] or [batch, nb, n], unit
    column strides, any row strides.  The strict upper part of ``l`` is
    never read, nor its diagonal when ``unit``."""
    if l.device.type == "cpu" and b.device.type == "cpu":
        return trsm_base_plain(l, b, unit=unit)
    if l.device != b.device or l.device.type != "cuda":
        raise ValueError(f"trsm: operands on {l.device} and {b.device}; "
                         f"both must be on one CUDA device")
    if l.dtype != b.dtype or l.dtype not in _DTYPES:
        raise TypeError(f"trsm: kernel takes matching float32 or float64 "
                        f"operands, got {l.dtype} and {b.dtype}")
    if l.dim() not in (2, 3) or l.dim() != b.dim():
        raise ValueError(f"trsm: shapes {tuple(l.shape)} and "
                         f"{tuple(b.shape)}; both 2-D or both 3-D")
    nb, n = l.shape[-1], b.shape[-1]
    if l.shape[-2] != nb or b.shape[-2] != nb or not 0 < nb <= BASE:
        raise ValueError(f"trsm: base block must be square with at most "
                         f"{BASE} rows matching B, got {tuple(l.shape)} "
                         f"and {tuple(b.shape)}")
    if l.dim() == 3 and l.shape[0] != b.shape[0]:
        raise ValueError(f"trsm: batch sizes {l.shape[0]} and {b.shape[0]}")
    if not (row_major(l) and row_major(b)):
        raise ValueError("trsm: operands need unit column strides and "
                         "non-overlapping rows; pass .contiguous()")
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    batched = l.dim() == 3
    l3 = l if batched else l.unsqueeze(0)
    b3 = b if batched else b.unsqueeze(0)
    x3 = out if batched else out.unsqueeze(0)
    global launches
    launches += 1
    rc = _entry()(CODES[l.dtype], l.data_ptr(), b.data_ptr(),
                  out.data_ptr(), nb, n, l3.stride(1), b3.stride(1),
                  x3.stride(1), l3.shape[0], l3.stride(0), b3.stride(0),
                  x3.stride(0), int(unit),
                  torch.cuda.current_stream(l.device).cuda_stream)
    compat.check(rc, "trsm")
    return out


def split_point(m: int) -> int:
    """Rows of the leading block: the largest power of two below ``m``
    (at least :data:`BASE`), halving instead when that is all of it
    (``repro/kernels/trsm.py:84-88``)."""
    half = max(BASE, 1 << (m - 1).bit_length() - 1)
    return m // 2 if half >= m else half


def _solve_lower(l: torch.Tensor, b: torch.Tensor, *, unit: bool,
                 base: Callable, update: Callable) -> torch.Tensor:
    m = l.shape[-1]
    if m <= BASE:
        return base(l, b, unit=unit)
    half = split_point(m)
    x1 = _solve_lower(l[..., :half, :half], b[..., :half, :], unit=unit,
                      base=base, update=update)
    upd = update(l[..., half:, :half], x1)
    x2 = _solve_lower(l[..., half:, half:], b[..., half:, :] - upd,
                      unit=unit, base=base, update=update)
    return torch.cat([x1, x2], dim=-2)


def _canonical(a: torch.Tensor, b: torch.Tensor, side: str, uplo: str,
               trans: str, diag: str, solve: Callable) -> torch.Tensor:
    """Reduce op(A) X = B (side L) or X op(A) = B (side R) to ``solve``
    on a contiguous lower-left-N problem (``repro/kernels/trsm.py:99-130``)."""
    if side == "R":
        # X op(A) = B  <=>  op(A)^T X^T = B^T
        flip_t = {"N": "T", "T": "N", "C": "N"}[trans]
        a_ = a.conj() if trans == "C" else a
        return _canonical(a_, b.mT, "L", uplo, flip_t, diag, solve).mT
    if trans != "N":
        # op(A) X = B with A lower  <=>  solve with upper A^(T|H)
        a_ = a.mH if trans == "C" else a.mT
        return _canonical(a_, b, "L", "U" if uplo == "L" else "L", "N",
                          diag, solve)
    if uplo == "U":
        # U X = B  <=>  (J U J)(J X) = (J B), J = index reversal
        xj = _canonical(torch.flip(a, dims=(-2, -1)),
                        torch.flip(b, dims=(-2,)), "L", "L", "N", diag,
                        solve)
        return torch.flip(xj, dims=(-2,))
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    m, n = b.shape[-2], b.shape[-1]
    if batch:
        a3 = a.expand(batch + a.shape[-2:]).reshape(-1, m, m).contiguous()
        b3 = b.expand(batch + b.shape[-2:]).reshape(-1, m, n).contiguous()
        return solve(a3, b3, unit=diag == "U").reshape(batch + (m, n))
    return solve(a.contiguous(), b.contiguous(), unit=diag == "U")


def trsm(a: torch.Tensor, b: torch.Tensor, *, side: str = "L",
         uplo: str = "L", trans: str = "N", diag: str = "N"
         ) -> torch.Tensor:
    """Solve op(A) X = B (side L) or X op(A) = B (side R) for real
    float32/float64 ``a`` [m, m] and ``b`` [m, n] (side L), or with
    matching leading batch dimensions: the base kernel on the diagonal
    blocks, the gemm kernel on the updates (their plain versions for CPU
    tensors)."""
    solve = functools.partial(_solve_lower, base=trsm_base, update=gemm)
    return _canonical(a, b, side, uplo, trans, diag, solve)


def trsm_plain(a: torch.Tensor, b: torch.Tensor, *, side: str = "L",
               uplo: str = "L", trans: str = "N", diag: str = "N"
               ) -> torch.Tensor:
    """The plain PyTorch version of :func:`trsm` on any device: the same
    reduction and recursion with :func:`trsm_base_plain` and
    ``gemm_plain`` in place of the kernels."""
    solve = functools.partial(_solve_lower, base=trsm_base_plain,
                              update=gemm_plain)
    return _canonical(a, b, side, uplo, trans, diag, solve)
