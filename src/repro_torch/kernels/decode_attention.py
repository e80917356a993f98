"""Single-token decode attention on the hand-written Hopper kernel
(``csrc/decode_attention.cu``).

The counterpart of ``repro/kernels/decode_attention.py`` (the Pallas
``decode_attention``, ``:72``, and ``_decode_kernel``, ``:29``).  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version, :func:`decode_attention_plain` (``ref.attention`` with
``kv_len``), which the CPU tests use and the chip check compares the
kernel with.

``kv_len`` is a host integer, passed to the kernel by value: the grid
covers only the live keys, so no key at or past ``kv_len`` is loaded.  The
kernel runs as two launches (the key chunks, then their combination)
into a float32 scratch buffer that this wrapper allocates; the launch
counter counts one per call.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import compat, ref
from repro_torch.kernels.attention import (CODES, LLP, check_kernel_inputs,
                                           check_shapes, strides, unit_last)

#: calls that launched the CUDA kernel since the last reset
launches = 0
#: the most query heads one KV head may serve (csrc MAXG)
MAX_GROUP = 8

_c_ll = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             LLP, LLP, LLP, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p]


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = compat.library("decode_attention")
    lib.repro_decode_attention.argtypes = _ARGTYPES
    lib.repro_decode_attention.restype = ctypes.c_int
    lib.repro_decode_scratch.argtypes = [ctypes.c_int] * 4
    lib.repro_decode_scratch.restype = _c_ll
    return lib


def _live(kv_len, s: int) -> int:
    n = int(kv_len)
    if not 1 <= n <= s:
        raise ValueError(f"decode_attention: kv_len {n} outside [1, {s}]")
    return n


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: int, *,
                           softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``ref.attention(...,
    causal=True, kv_len=kv_len)`` for one right-aligned query token."""
    return ref.attention(q, k, v, causal=True, kv_len=kv_len,
                         softcap=softcap, scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: int, *, softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, 1, D]; k, v: [B, Hkv, S, D]; ``kv_len``: the live
    length, 1 <= kv_len <= S.  Returns [B, Hq, 1, D] in q's dtype."""
    check_shapes("decode_attention", q, k, v)
    if q.shape[2] != 1:
        raise ValueError(f"decode_attention: single-token kernel, got "
                         f"Tq = {q.shape[2]}")
    n = _live(kv_len, k.shape[2])
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return decode_attention_plain(q, k, v, n, softcap=softcap,
                                      scale=scale)
    check_kernel_inputs("decode_attention", q, k, v)
    b, hq, _, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {hq // hkv} query heads per KV "
                         f"head, the kernel takes at most {MAX_GROUP}")
    q, k, v = unit_last(q), unit_last(k), unit_last(v)
    sc = float(scale if scale is not None else 1.0 / math.sqrt(d))
    lib = _lib()
    part = torch.empty(lib.repro_decode_scratch(b, hq, d, n),
                       dtype=torch.float32, device=q.device)
    out = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    global launches
    launches += 1
    rc = lib.repro_decode_attention(
        CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), part.data_ptr(), b, hq, hkv, s_len, d, n,
        strides(q, (0, 1)), strides(k, (0, 1, 2)), strides(v, (0, 1, 2)),
        sc, float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    compat.check(rc, "decode_attention")
    return out
