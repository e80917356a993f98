"""Triangular solve on the hand-written Hopper kernel (``csrc/trsm.cu``):
one or two launches per lower-left solve.

The counterpart of ``repro/kernels/trsm.py``.  All eight (side, uplo,
trans) variants reduce to lower-left-N by transposition, conjugation and
index reversal (:func:`_canonical`), and :func:`plan` picks one of the
kernel's two schedules for that problem from its shape, batched calls
included.  The dataflow path is one launch: 64-row block rows that each
take every ``X_j`` above them as soon as it is published, with the
diagonal block applied as its inverse and the last update folded into it.
The wide path, where the right-hand sides alone fill the card, is a
prologue that inverts each diagonal block once, then one block per
128-column panel walking 128-row block rows (see the note in
``csrc/trsm.cu``).  There is no recursion on the card.

On a CUDA tensor :func:`solve_lower` launches the kernel or raises; on a
CPU tensor it takes the plan's order in plain PyTorch
(:func:`_dataflow_lower` or :func:`_wide_lower`).
:func:`trsm_dataflow_plain` is the dataflow order at any shape, which the
chip check also compares either path with.  :func:`trsm_plain` keeps the
recursion of the TPU kernel's wrapper (power-of-two splits over
substitution blocks of at most :data:`BASE` rows, gemm updates) as a
second plain version.  Real float32 and float64 only: complex solves stay
on the library
(``kernels/ops.py``), as in the reference.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import compat, ref
from repro_torch.kernels.gemm import CODES, gemm_plain, row_major

#: largest diagonal block of the recursion's substitution (trsm_plain)
BASE = 128
#: rows of the kernel's block rows and columns of its panels
NB, PANEL = 64, 32
#: the wide path's block rows (two NB-row diagonal steps) and panels
WIDE_ROWS, WIDE_PANEL = 128, 128
#: SMs of an H100: the wide path is taken where its panels fill them
SMS = 132

#: launches of the CUDA kernels since the last reset (one per dataflow
#: solve, two per wide solve: the prologue and the main launch)
launches = 0
#: zeroing memsets of the dataflow path's flags (one per launch)
memsets = 0
#: solves that took the wide path
wide_launches = 0

_c_ll = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _c_ll, _c_ll,
             _c_ll, ctypes.c_int, _c_ll, _c_ll, _c_ll, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]
#: repro_trsm_wide: the scratch pointer after X, no flags
_WIDE_ARGTYPES = _ARGTYPES[:4] + [ctypes.c_void_p] + _ARGTYPES[4:14] + [
    ctypes.c_void_p]
_DTYPES = (torch.float32, torch.float64)


def reset_launches() -> None:
    global launches, memsets, wide_launches
    launches = 0
    memsets = 0
    wide_launches = 0


def _entry(name: str = "repro_trsm", argtypes: list = _ARGTYPES):
    fn = getattr(compat.library("trsm"), name)
    fn.argtypes = argtypes
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
    CUDA solve of any size is :func:`solve_lower`'s launch)."""
    if l.device.type == "cpu" and b.device.type == "cpu":
        return trsm_base_plain(l, b, unit=unit)
    raise ValueError(f"trsm_base: operands on {l.device} and {b.device}; "
                     f"the base block runs on the CPU only, and a CUDA "
                     f"solve is solve_lower's launch")


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
    """The dataflow path's work units (blocks): block rows x panels x
    batch."""
    return -(-m // NB) * -(-n // PANEL) * batch


class Plan(NamedTuple):
    """The schedule of a lower-left solve: the wide path or the dataflow
    path, and the blocks of its main launch."""
    wide: bool
    blocks: int


def plan(m: int, n: int, batch: int) -> Plan:
    """The wide path where its panels of :data:`WIDE_PANEL` columns give
    every SM a block (CheFSI's m 2400, n 93536: 731), else the dataflow
    path (potrf's panel solve, m 256 and n 6656: 52 panels; getrs's 6912
    x 32: 1).  Pure arithmetic on the shape, so the CPU tests reach it."""
    panels = -(-n // WIDE_PANEL) * batch
    if panels >= SMS:
        return Plan(True, panels)
    return Plan(False, units(m, n, batch))


def solve_lower(l: torch.Tensor, b: torch.Tensor, *,
                unit: bool) -> torch.Tensor:
    """X = L^-1 B for lower ``l`` [m, m] or [batch, m, m] and ``b`` [m, n]
    or [batch, m, n] (unit column strides, any row strides), on the path
    :func:`plan` picks: on a CUDA tensor one launch of the dataflow path
    after one memset of its flags, or the wide path's two launches; on a
    CPU tensor that path's order in plain PyTorch."""
    m, n = l.shape[-1], b.shape[-1]
    batch = l.shape[0] if l.dim() == 3 else 1
    wide = plan(m, n, batch).wide
    if l.device.type == "cpu" and b.device.type == "cpu":
        return (_wide_lower if wide else _dataflow_lower)(l, b, unit=unit)
    _check(l, b)
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    batched = l.dim() == 3
    l3 = l if batched else l.unsqueeze(0)
    b3 = b if batched else b.unsqueeze(0)
    x3 = out if batched else out.unsqueeze(0)
    shape = (m, n, l3.stride(1), b3.stride(1), x3.stride(1), batch,
             l3.stride(0), b3.stride(0), x3.stride(0), int(unit))
    stream = torch.cuda.current_stream(l.device).cuda_stream
    if wide:
        # each diagonal block's inverse, then the folded M_i (odd blocks)
        diag = torch.empty(batch * -(-m // NB) * 2 * NB * NB,
                           dtype=b.dtype, device=b.device)
        compat.count(globals(), launches=2, wide_launches=1)
        rc = _entry("repro_trsm_wide", _WIDE_ARGTYPES)(
            CODES[l.dtype], l.data_ptr(), b.data_ptr(), out.data_ptr(),
            diag.data_ptr(), *shape, stream)
    else:
        # per (batch, panel) chain the count of published block rows,
        # then the ticket counter
        flags = torch.zeros(batch * -(-n // PANEL) + 1, dtype=torch.int32,
                            device=b.device)
        compat.count(globals(), memsets=1, launches=1)
        rc = _entry()(CODES[l.dtype], l.data_ptr(), b.data_ptr(),
                      out.data_ptr(), *shape, flags.data_ptr(), stream)
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


def _wide_lower(l: torch.Tensor, b: torch.Tensor, *,
                unit: bool) -> torch.Tensor:
    """The wide path's order in plain PyTorch: the diagonal blocks'
    inverses once, then block rows of :data:`WIDE_ROWS` in order, each R =
    B_I - L_I,<I X_<I in one product, X_a = W_a R_a and X_b = W_b R_b -
    M_b X_a with M_b = W_b L_ba."""
    m = l.shape[-1]
    inv = _diag_inverses(l, unit=unit)
    mm = ref.torch_matmul
    x = torch.empty_like(b)
    for i in range(0, m, WIDE_ROWS):
        e, h = min(i + WIDE_ROWS, m), min(i + NB, m)
        r = b[..., i:e, :]
        if i:
            r = r - mm(l[..., i:e, :i], x[..., :i, :])
        x[..., i:h, :] = mm(inv[..., i // NB, :h - i, :h - i],
                            r[..., :h - i, :])
        if h < e:
            w = inv[..., i // NB + 1, :e - h, :e - h]
            x[..., h:e, :] = (mm(w, r[..., h - i:, :])
                              - mm(mm(w, l[..., h:e, i:h]), x[..., i:h, :]))
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
    matching leading batch dimensions: the kernel's path that
    :func:`plan` picks on CUDA tensors, that path's plain order on CPU
    tensors."""
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
