"""Flash attention for prefill on the hand-written Hopper kernel
(``csrc/flash_attention.cu``).

The counterpart of ``repro/kernels/attention.py`` (the Pallas
``flash_attention``, ``:85``, and ``_flash_kernel``, ``:28``).  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version, :func:`flash_attention_plain` (the ``ref.attention`` formula),
which the CPU tests use and the chip check compares the kernel with.

The kernel walks only the key tiles that the causal and window masks
leave live, masks ragged Tq and Tk itself (so the wrapper neither pads
nor crops), and reads K and V through the GQA head map without copying
them per query head.  One deliberate difference from the TPU kernel: keys
past a ragged Tk are always masked, so ``causal=False`` with
``Tk % block != 0`` gives what ``ref.attention`` gives, where the TPU
kernel lets its zero padding into the softmax (``attention.py:58-63`` and
``:96-100``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import compat, ref

#: launches of the CUDA kernel since the last reset
launches = 0

#: dtype codes of csrc/flash_attention.cu and csrc/decode_attention.cu
CODES = {torch.float32: 0, torch.bfloat16: 2, torch.float16: 3}
#: head sizes the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)

_c_ll = ctypes.c_longlong
#: a ``const long long*`` stride array (a ctypes array converts to it)
LLP = ctypes.POINTER(_c_ll)
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, LLP, LLP, LLP,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def reset_launches() -> None:
    global launches
    launches = 0


def _entry():
    fn = compat.library("flash_attention").repro_flash_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def strides(x: torch.Tensor, dims) -> "ctypes.Array":
    """The element strides of ``dims`` as the kernels' long long array."""
    return (_c_ll * len(dims))(*(x.stride(i) for i in dims))


def unit_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its last dim has unit stride, else a copy."""
    return x if x.stride(-1) == 1 or x.shape[-1] <= 1 else x.contiguous()


def check_kernel_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Device, dtype and head-size checks shared by both attention
    kernels; raises on what they do not take."""
    if not (q.device == k.device == v.device and q.device.type == "cuda"):
        raise ValueError(f"{name}: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}; all must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in CODES:
        raise TypeError(f"{name}: kernel takes matching float32, bfloat16 "
                        f"or float16 q, k, v, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head size {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")


def check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q [B, Hq, Tq, D] and k, v "
                         f"[B, Hkv, Tk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]
            or q.shape[1] % k.shape[1]):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (Hq must be a multiple of Hkv)")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``ref.attention`` with no
    ``kv_len`` (float32 inside, output in q's dtype)."""
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D] with Hq % Hkv == 0.
    Query rows are right-aligned to the keys (``q_offset = Tk - Tq``).
    Returns [B, Hq, Tq, D] in q's dtype."""
    check_shapes("flash_attention", q, k, v)
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    check_kernel_inputs("flash_attention", q, k, v)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    q, k, v = unit_last(q), unit_last(k), unit_last(v)
    s = float(scale if scale is not None else 1.0 / math.sqrt(d))
    out = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    global launches
    launches += 1
    rc = _entry()(CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, hq, hkv, tq, tk, d,
                  strides(q, (0, 1, 2)), strides(k, (0, 1, 2)),
                  strides(v, (0, 1, 2)), s, float(softcap), int(causal),
                  int(window), torch.cuda.current_stream(q.device).cuda_stream)
    compat.check(rc, "flash_attention")
    return out
