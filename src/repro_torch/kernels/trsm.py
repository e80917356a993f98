"""Triangular solve on the hand-written Hopper kernel (``csrc/trsm.cu``):
one launch per lower-left solve.

The counterpart of ``repro/kernels/trsm.py``.  All eight (side, uplo,
trans) variants reduce to lower-left-N by transposition, conjugation and
index reversal (:func:`_canonical`), and that problem is one launch of the
kernel, batched calls included: 64-row block rows that each take every
``X_j`` above them as soon as it is published, with the diagonal block
applied as its inverse and the last update folded into it (see the note
in ``csrc/trsm.cu``).  There is no recursion on the card.

On a CUDA tensor :func:`solve_lower` launches the kernel or raises; on a
CPU tensor it takes :func:`trsm_dataflow_plain`'s order, the kernel's
block rows in plain PyTorch, which the chip check also compares the
kernel with.  :func:`trsm_plain` keeps the recursion of the TPU kernel's
wrapper (power-of-two splits over substitution blocks of at most
:data:`BASE` rows, gemm updates) as a second plain version.  Real
float32 and float64 only: complex solves stay on the library
(``kernels/ops.py``), as in the reference.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from repro_torch.kernels import compat, ref
from repro_torch.kernels.gemm import CODES, gemm_plain, row_major

#: largest diagonal block of the recursion's substitution (trsm_plain)
BASE = 128
#: rows of the kernel's block rows and columns of its panels
NB, PANEL = 64, 32

#: launches of the CUDA kernel since the last reset (one per solve)
launches = 0
#: zeroing memsets of the kernel's flags (one per launch), counted apart
memsets = 0

_c_ll = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _c_ll, _c_ll,
             _c_ll, ctypes.c_int, _c_ll, _c_ll, _c_ll, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]
_DTYPES = (torch.float32, torch.float64)


def reset_launches() -> None:
    global launches, memsets
    launches = 0
    memsets = 0


def _entry():
    fn = compat.library("trsm").repro_trsm
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
    never read, nor its diagonal when ``unit``.  CPU tensors only: it is
    :func:`trsm_plain`'s base block, and the card has no base kernel (a
    CUDA solve of any size is one launch of :func:`solve_lower`)."""
    if l.device.type == "cpu" and b.device.type == "cpu":
        return trsm_base_plain(l, b, unit=unit)
    raise ValueError(f"trsm_base: operands on {l.device} and {b.device}; "
                     f"the base block runs on the CPU only, and a CUDA "
                     f"solve is solve_lower's one launch")


def _check(l: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if l.device != b.device or l.device.type != "cuda":
        raise ValueError(f"trsm: operands on {l.device} and {b.device}; "
                         f"both must be on one CUDA device")
    if l.dtype != b.dtype or l.dtype not in _DTYPES:
        raise TypeError(f"trsm: kernel takes matching float32 or float64 "
                        f"operands, got {l.dtype} and {b.dtype}")
    if l.dim() not in (2, 3) or l.dim() != b.dim():
        raise ValueError(f"trsm: shapes {tuple(l.shape)} and "
                         f"{tuple(b.shape)}; both 2-D or both 3-D")
    m = l.shape[-1]
    if l.shape[-2] != m or b.shape[-2] != m:
        raise ValueError(f"trsm: L must be square with as many rows as B, "
                         f"got {tuple(l.shape)} and {tuple(b.shape)}")
    if l.dim() == 3 and l.shape[0] != b.shape[0]:
        raise ValueError(f"trsm: batch sizes {l.shape[0]} and {b.shape[0]}")
    if not (row_major(l) and row_major(b)):
        raise ValueError("trsm: operands need unit column strides and "
                         "non-overlapping rows; pass .contiguous()")


def units(m: int, n: int, batch: int) -> int:
    """The kernel's work units (blocks): block rows x panels x batch."""
    return -(-m // NB) * -(-n // PANEL) * batch


def solve_lower(l: torch.Tensor, b: torch.Tensor, *,
                unit: bool) -> torch.Tensor:
    """X = L^-1 B for lower ``l`` [m, m] or [batch, m, m] and ``b`` [m, n]
    or [batch, m, n] (unit column strides, any row strides): one launch
    of the kernel on a CUDA tensor, after one memset of its flags;
    :func:`trsm_dataflow_plain`'s order on a CPU tensor."""
    if l.device.type == "cpu" and b.device.type == "cpu":
        return _dataflow_lower(l, b, unit=unit)
    _check(l, b)
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    batched = l.dim() == 3
    l3 = l if batched else l.unsqueeze(0)
    b3 = b if batched else b.unsqueeze(0)
    x3 = out if batched else out.unsqueeze(0)
    m, n, batch = l3.shape[-1], b3.shape[-1], l3.shape[0]
    # per (batch, panel) chain the count of published block rows, then
    # the ticket counter
    flags = torch.zeros(batch * -(-n // PANEL) + 1, dtype=torch.int32,
                        device=b.device)
    global launches, memsets
    with compat.COUNT_LOCK:
        memsets += 1
        launches += 1
    rc = _entry()(CODES[l.dtype], l.data_ptr(), b.data_ptr(),
                  out.data_ptr(), m, n, l3.stride(1), b3.stride(1),
                  x3.stride(1), batch, l3.stride(0), b3.stride(0),
                  x3.stride(0), int(unit), flags.data_ptr(),
                  torch.cuda.current_stream(l.device).cuda_stream)
    compat.check(rc, "trsm")
    return out


def _diag_inverses(l: torch.Tensor, *, unit: bool) -> torch.Tensor:
    """[..., blocks, NB, NB]: the inverse of each NB-row diagonal block of
    ``l`` (the last one padded with the identity), by the kernel's
    substitution on the identity (:func:`trsm_base_plain`)."""
    m = l.shape[-1]
    nblk = -(-m // NB)
    pad = nblk * NB - m
    lp = torch.nn.functional.pad(l, (0, pad, 0, pad))
    lp.diagonal(dim1=-2, dim2=-1)[..., m:] = 1
    blocks = torch.stack([lp[..., i * NB:(i + 1) * NB, i * NB:(i + 1) * NB]
                          for i in range(nblk)], dim=-3)
    eye = torch.eye(NB, dtype=l.dtype, device=l.device)
    return trsm_base_plain(blocks, eye.expand(blocks.shape).contiguous(),
                           unit=unit)


def _dataflow_lower(l: torch.Tensor, b: torch.Tensor, *,
                    unit: bool) -> torch.Tensor:
    """The kernel's order in plain PyTorch: block row i takes R'_i = B_i -
    sum_{j<i-1} L_ij X_j, one j at a time, then X_i = L_ii^-1 R'_i -
    M_i X_{i-1} with M_i = L_ii^-1 L_i,i-1."""
    m = l.shape[-1]
    inv = _diag_inverses(l, unit=unit)
    mm = ref.torch_matmul
    x = torch.empty_like(b)
    for blk, i in enumerate(range(0, m, NB)):
        e = min(i + NB, m)
        w = inv[..., blk, :e - i, :e - i]
        r = b[..., i:e, :].clone()
        for j in range(0, i - NB, NB):
            r -= mm(l[..., i:e, j:j + NB], x[..., j:j + NB, :])
        x[..., i:e, :] = mm(w, r)
        if i:
            x[..., i:e, :] -= mm(mm(w, l[..., i:e, i - NB:i]),
                                 x[..., i - NB:i, :])
    return x


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
    matching leading batch dimensions: one kernel launch on CUDA tensors,
    :func:`trsm_dataflow_plain`'s arithmetic on CPU tensors."""
    return _canonical(a, b, side, uplo, trans, diag, solve_lower)


def trsm_dataflow_plain(a: torch.Tensor, b: torch.Tensor, *,
                        side: str = "L", uplo: str = "L", trans: str = "N",
                        diag: str = "N") -> torch.Tensor:
    """The plain PyTorch version of the kernel on any device: the same
    reduction to lower-left-N, then the kernel's 64-row block rows in
    order, each diagonal block applied as its inverse."""
    return _canonical(a, b, side, uplo, trans, diag, _dataflow_lower)


def trsm_plain(a: torch.Tensor, b: torch.Tensor, *, side: str = "L",
               uplo: str = "L", trans: str = "N", diag: str = "N"
               ) -> torch.Tensor:
    """The TPU wrapper's recursion in plain PyTorch on any device: the
    same reduction, power-of-two splits, :func:`trsm_base_plain` on the
    diagonal blocks and ``gemm_plain`` on the updates."""
    solve = functools.partial(_solve_lower, base=trsm_base_plain,
                              update=gemm_plain)
    return _canonical(a, b, side, uplo, trans, diag, solve)
