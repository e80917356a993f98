"""Plain PyTorch versions of the functions the port's kernels compute.

The counterparts of ``repro/kernels/ref.py``: the ground truth the kernel
tests compare against, and the library calls for the work the reference
also leaves outside its kernels (complex trsm and syrk, the residual
check, attention on the decode steps of windowed layers).

``torch.matmul`` is captured when this module is imported, before any
session patches the public symbols, so nothing here re-enters the
interceptor (``repro_torch.core.intercept``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

#: the un-intercepted matrix product, for every plain product in the port
torch_matmul = torch.matmul

_NATIVE_ACC = (torch.float64, torch.complex64, torch.complex128)


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B, accumulated in float32 for bf16/f16/f32 inputs and in
    the input type for float64, complex64 and complex128 (the rule of
    ``repro/kernels/ref.py:15-22``)."""
    acc = a.dtype if a.dtype in _NATIVE_ACC else torch.float32
    out = torch_matmul(a.to(acc), b.to(acc))
    return out.to(out_dtype or a.dtype)


def triangle(a: torch.Tensor, uplo: str, diag: str = "N") -> torch.Tensor:
    """The triangle of A that BLAS references, with a unit diagonal
    written in when ``diag == "U"``."""
    t = torch.tril(a) if uplo == "L" else torch.triu(a)
    if diag == "U":
        t = t.clone()
        t.diagonal(dim1=-2, dim2=-1).fill_(1)
    return t


def syrk(a: torch.Tensor, *, uplo: str = "L", trans: str = "N"
         ) -> torch.Tensor:
    """C = op(A) op(A)^T with :func:`matmul`'s accumulation rule, only
    the ``uplo`` triangle populated and zeros elsewhere
    (``repro/kernels/ref.py:37-41``)."""
    opa = a if trans == "N" else a.mT
    full = matmul(opa, opa.mT)
    return torch.tril(full) if uplo == "L" else torch.triu(full)


def trsm(a: torch.Tensor, b: torch.Tensor, *, side: str = "L",
         uplo: str = "L", trans: str = "N", diag: str = "N"
         ) -> torch.Tensor:
    """Solve op(A) X = B (side L) or X op(A) = B (side R) with
    ``torch.linalg.solve_triangular``.  That routine reads both
    triangles, so the one BLAS does not reference is masked off first.
    bf16/f16 solve in float32."""
    dt = b.dtype
    work = dt if dt in _NATIVE_ACC or dt == torch.float32 else torch.float32
    t = triangle(a, uplo, diag).to(work)
    upper = uplo == "U"
    if trans != "N":
        t = t.mH if trans == "C" else t.mT
        upper = not upper
    x = torch.linalg.solve_triangular(t, b.to(work), upper=upper,
                                      left=(side == "L"),
                                      unitriangular=(diag == "U"))
    return x.to(dt)


#: the masked-logit value of ``repro/kernels/ref.py:88``: finite, so a row
#: whose keys are all masked gives exp(0) = 1, never exp(-inf + inf)
NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None, kv_len: Optional[int] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Attention in float32, ``repro/kernels/ref.py:44-90``.  q is
    [B, Hq, Tq, D], k and v [B, Hkv, Tk, D] with Hq a multiple of Hkv
    (GQA).  The logits are scaled, then soft-capped (``tanh(x / c) * c``),
    then masked: keys at or past ``kv_len`` (default Tk), and with
    ``causal`` keys after the query, with ``window`` keys ``window`` or
    more behind it.  Queries sit right-aligned at positions
    ``kv_len - Tq .. kv_len - 1``."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch_matmul(qf, kf.mT) * s
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    live = tk if kv_len is None else int(kv_len)
    qpos = torch.arange(tq, device=q.device)[:, None] + (live - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = kpos < live
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch_matmul(p, vf).to(out_dtype or q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      chunk_q: int, softcap: float = 0.0,
                      scale: Optional[float] = None,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Causal attention in query chunks with causally sliced keys,
    ``repro/kernels/ref.py:93-117``: chunk i attends to keys
    [0, (i + 1) * chunk_q) only, so the masked upper triangle is never
    computed."""
    t = q.shape[2]
    if t % chunk_q:
        raise ValueError(f"attention_chunked: T={t} is not a multiple of "
                         f"chunk_q={chunk_q}")
    outs = []
    for i in range(t // chunk_q):
        klen = (i + 1) * chunk_q
        outs.append(attention(q[:, :, i * chunk_q:klen], k[:, :, :klen],
                              v[:, :, :klen], causal=True, softcap=softcap,
                              scale=scale, out_dtype=out_dtype))
    return torch.cat(outs, dim=2)
