"""Single-token decode attention on the hand-written Hopper kernel
(``csrc/decode_attention.cu``).

The counterpart of ``repro/kernels/decode_attention.py`` (the Pallas
``decode_attention``, ``:72``, and ``_decode_kernel``, ``:29``).  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version, :func:`decode_attention_plain` (``ref.attention`` with
``kv_len``), which the CPU tests use and the chip check compares the
kernel with.  :func:`decode_chunks_plain` is the kernel's own order in
plain PyTorch: the chunks of :func:`plan`, each with its exact max, then
their combination in chunk order.

``kv_len`` is a host integer, or a one-element int32 tensor as the
reference takes a ``jax.Array``.  On the card a tensor ``kv_len`` stays on
the device: the kernel reads it there, and the grid covers every chunk of
the cache, the ones past ``kv_len`` returning at once; a host integer
gives a grid of only the live chunks.  The two agree bit for bit.  Each
call is one launch: the last block of each (b, KV head) pair combines its
chunks, found by a ticket in B * Hkv words that the call zeroes first (one
memset, counted in :data:`memsets`).  A k or v view that the kernel's
16-byte copies cannot read is copied first and counted in :data:`copies`.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels import compat, ref
from repro_torch.kernels.attention import (CODES, LLP, check_kernel_inputs,
                                           check_shapes, strides, unit_last)

#: calls that launched the CUDA kernel since the last reset
launches = 0
#: zeroing memsets of the kernel's tickets (one per launch), counted apart
memsets = 0
#: k or v operands copied to meet the kernel's 16-byte rules
copies = 0
#: the most query heads one KV head may serve (csrc MAXG)
MAX_GROUP = 8
#: streaming multiprocessors of an H100 SXM, and the kernel's blocks per SM
#: (64 KB ring plus at most 32 KB of logits each)
SMS, BLOCKS_PER_SM = 132, 2
#: a chunk is a multiple of CHUNK_ALIGN keys, at most MAX_CHUNK (csrc)
CHUNK_ALIGN, MAX_CHUNK = 32, 1024

_c_ll = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, LLP, LLP, LLP, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p]

KvLen = Union[int, torch.Tensor]


class Plan(NamedTuple):
    chunk: int      # keys per block
    grid: int       # chunks launched per (b, KV head)
    blocks: int     # blocks launched


def reset_launches() -> None:
    global launches, memsets, copies
    launches = 0
    memsets = 0
    copies = 0


def _entry():
    fn = compat.library("decode_attention").repro_decode_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def plan(b: int, hkv: int, s: int, d: int,
         kv_len: Optional[int] = None) -> Plan:
    """The kernel's key chunks for a [b, hkv, s, d] cache.  The chunk
    depends on the cache alone, so a kv_len by value and one on the device
    split the keys alike: as many chunks per (b, KV head) pair as one wave
    of SMS x BLOCKS_PER_SM blocks holds for all pairs, each a multiple of
    CHUNK_ALIGN keys, at most MAX_CHUNK.  ``kv_len`` None (on the device):
    the grid covers every chunk of ``s``; else only the live ones."""
    if min(b, hkv, s, d) < 1:
        raise ValueError(f"decode_attention.plan: empty shape "
                         f"({b}, {hkv}, {s}, {d})")
    per_pair = max(1, SMS * BLOCKS_PER_SM // (b * hkv))
    chunk = -(-s // per_pair)
    chunk = min(MAX_CHUNK, -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN)
    grid = -(-(s if kv_len is None else _live(kv_len, s)) // chunk)
    return Plan(chunk, grid, grid * b * hkv)


def _live(kv_len: int, s: int) -> int:
    n = int(kv_len)
    if not 1 <= n <= s:
        raise ValueError(f"decode_attention: kv_len {n} outside [1, {s}]")
    return n


def _host_len(kv_len: KvLen) -> Optional[int]:
    """kv_len as a host integer, or None for a one-element int32 tensor on
    a CUDA device (which the kernel reads there)."""
    if not isinstance(kv_len, torch.Tensor):
        return int(kv_len)
    if kv_len.numel() != 1 or kv_len.dtype != torch.int32:
        raise ValueError(f"decode_attention: a tensor kv_len must be one "
                         f"int32 element, got {kv_len.dtype} of shape "
                         f"{tuple(kv_len.shape)}")
    return None if kv_len.device.type == "cuda" else int(kv_len)


def _copy_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` (k or v) itself when the kernel's 16-byte copies can read it
    (a unit stride on D, an aligned base, b, h, t strides of whole 16
    bytes), else a contiguous copy, counted in :data:`copies`."""
    es = x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(x.stride(i) * es % 16 == 0 for i in range(3))):
        return x
    compat.count(globals(), copies=1)
    return x.contiguous()


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: KvLen, *,
                           softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``ref.attention(...,
    causal=True, kv_len=kv_len)`` for one right-aligned query token."""
    return ref.attention(q, k, v, causal=True, kv_len=int(kv_len),
                         softcap=softcap, scale=scale)


def decode_chunks_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: KvLen, *, softcap: float = 0.0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's order in plain PyTorch, float32: per chunk of
    :func:`plan`, logits in log2 units (the soft-cap as ``c (1 - 2 / (1 +
    2^(2 y log2 e)))``), the chunk's exact max m, p = 2^(x - m), its sum l
    and p.V; then the chunks combined in chunk order with weights
    2^(m_c - max m), the output acc / max(l, 1e-30) in q's dtype."""
    check_shapes("decode_chunks_plain", q, k, v)
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    n = _live(int(kv_len), s)
    group = hq // hkv
    log2e = 1.4426950408889634
    sc = float(scale if scale is not None else 1.0 / math.sqrt(d))
    qf = q.float().reshape(b, hkv, group, d)
    chunk = plan(b, hkv, s, d, n).chunk
    parts = []
    for c0 in range(0, n, chunk):
        kf = k[:, :, c0:min(c0 + chunk, n)].float()
        vf = v[:, :, c0:min(c0 + chunk, n)].float()
        x = ref.torch_matmul(qf, kf.mT)                  # [b, hkv, group, nk]
        if softcap > 0.0:
            x = softcap * log2e * (1.0 - 2.0 / (
                1.0 + torch.exp2(x * (2.0 * log2e * sc / softcap))))
        else:
            x = x * (sc * log2e)
        m = x.amax(-1, keepdim=True)
        p = torch.exp2(x - m)
        parts.append((m, p.sum(-1, keepdim=True), ref.torch_matmul(p, vf)))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(top)
    acc = torch.zeros_like(parts[0][2])
    for m, lc, ac in parts:
        w = torch.exp2(m - top)
        l = l + lc * w
        acc = acc + ac * w
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, hq, 1, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: KvLen, *, softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, 1, D]; k, v: [B, Hkv, S, D]; ``kv_len``: the live
    length, 1 <= kv_len <= S, a host integer or a one-element int32
    tensor.  Returns [B, Hq, 1, D] in q's dtype."""
    check_shapes("decode_attention", q, k, v)
    if q.shape[2] != 1:
        raise ValueError(f"decode_attention: single-token kernel, got "
                         f"Tq = {q.shape[2]}")
    s_len = k.shape[2]
    n = _host_len(kv_len)
    if all(x.device.type == "cpu" for x in (q, k, v)):
        n = _live(kv_len if n is None else n, s_len)
        return decode_attention_plain(q, k, v, n, softcap=softcap,
                                      scale=scale)
    check_kernel_inputs("decode_attention", q, k, v)
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {hq // hkv} query heads per KV "
                         f"head, the kernel takes at most {MAX_GROUP}")
    if n is None:
        if kv_len.device != q.device:
            raise ValueError(f"decode_attention: kv_len on {kv_len.device}, "
                             f"q on {q.device}")
    else:
        n = _live(n, s_len)
    q, k, v = unit_last(q), _copy_ready(k), _copy_ready(v)
    p = plan(b, hkv, s_len, d, n)
    sc = float(scale if scale is not None else 1.0 / math.sqrt(d))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = torch.empty(b * hq * p.grid * (d + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    tickets = torch.zeros(b * hkv, dtype=torch.int32, device=q.device)
    compat.count(globals(), memsets=1, launches=1)
    rc = _entry()(
        CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        kv_len.data_ptr() if n is None else None, b, hq, hkv, s_len, d,
        0 if n is None else n, p.chunk, p.grid, strides(q, (0, 1)),
        strides(k, (0, 1, 2)), strides(v, (0, 1, 2)), sc, float(softcap),
        stream)
    compat.check(rc, "decode_attention")
    return out
