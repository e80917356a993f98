"""Flash attention for prefill on the hand-written Hopper kernel
(``csrc/flash_attention.cu``).

The counterpart of ``repro/kernels/attention.py`` (the Pallas
``flash_attention``, ``:85``, and ``_flash_kernel``, ``:28``).  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version, :func:`flash_attention_plain` (the ``ref.attention`` formula),
which the CPU tests use and the chip check compares the kernel with.

The kernel has two paths, and :func:`plan` picks one from the dtype, the
head size and the operands' layout alone: bf16/f16 at D = 64, 128 or 256
run on the tensor cores (wgmma fed by TMA), float32 and D = 16 or 32 on
the FMA units.  An operand that breaks the chosen path's layout rules is
copied with ``.contiguous()`` first, and the copy is counted
(:data:`copies`).  :func:`flash_tiles_plain` is the wgmma path's
arithmetic in plain PyTorch (its tiles, its form of tanh, P rounded to
the 16-bit type before P.V), for the CPU tests.

The kernel walks only the key tiles that the causal and window masks
leave live, masks ragged Tq and Tk itself (so the wrapper neither pads
nor crops), and reads K and V through the GQA head map without copying
them per query head.  One deliberate difference from the TPU kernel: keys
past a ragged Tk are always masked, so ``causal=False`` with
``Tk % block != 0`` gives what ``ref.attention`` gives, where the TPU
kernel lets its zero padding into the softmax (``attention.py:58-63`` and
``:96-100``).

Inside autograd (training), :func:`flash_attention` is a
``torch.library`` custom op: its forward is the kernel, its backward
recomputes the attention from q, k and v with the plain formulation
(:func:`flash_attention_plain`) under autograd.  The JAX package writes
no backward kernel to port (no ``custom_vjp`` under ``repro/kernels``),
so this one is plain PyTorch; a flash backward kernel is later
performance work, not a port requirement.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import compat, ref

#: the kernel's paths (csrc/flash_attention.cu)
WGMMA, FMA = "wgmma", "fma"
#: head sizes the wgmma path takes (whole 64-column TMA boxes of D)
WGMMA_HEAD_DIMS = (64, 128, 256)
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)

#: launches of the CUDA kernel since the last reset, in all and per path
launches = 0
launches_by_path = {WGMMA: 0, FMA: 0}
#: operands copied to meet a path's layout rules since the last reset
copies = 0

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


class Plan(NamedTuple):
    path: str                       # WGMMA or FMA
    copy: Tuple[bool, bool, bool]   # q, k, v each copied before the launch


def reset_launches() -> None:
    global launches, copies
    launches = 0
    copies = 0
    launches_by_path.update({WGMMA: 0, FMA: 0})


def _entry(path: str):
    lib = compat.library("flash_attention")
    fn = (lib.repro_flash_attention_wgmma if path == WGMMA
          else lib.repro_flash_attention)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def tma_ready(x: torch.Tensor) -> bool:
    """The wgmma path's TMA rules for one of q, k, v: a 16-byte aligned
    base, a unit stride on D, and b, h, t strides that are positive
    multiples of 16 bytes."""
    es = x.element_size()
    return (x.data_ptr() % 16 == 0 and x.stride(-1) == 1
            and all(x.stride(i) > 0 and x.stride(i) * es % 16 == 0
                    for i in range(3)))


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The kernel's path for these operands, and which of them it copies:
    the wgmma path for bf16/f16 at a head size of :data:`WGMMA_HEAD_DIMS`
    (an operand off the TMA rules is copied), else the FMA path (float32,
    whose tolerance TF32 would miss, and D = 16 or 32; an operand without
    a unit stride on D is copied).  Fixed by dtype, D and layout: never a
    fallback taken on failure."""
    if q.dtype in _WGMMA_DTYPES and q.shape[-1] in WGMMA_HEAD_DIMS:
        return Plan(WGMMA, tuple(not tma_ready(x) for x in (q, k, v)))
    return Plan(FMA, tuple(x.stride(-1) != 1 and x.shape[-1] > 1
                           for x in (q, k, v)))


def strides(x: torch.Tensor, dims) -> "ctypes.Array":
    """The element strides of ``dims`` as the kernels' long long array."""
    return (_c_ll * len(dims))(*(x.stride(i) for i in dims))


def unit_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its last dim has unit stride, else a copy (the
    decode kernel's rule)."""
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


#: the wgmma path's tiles: query rows per block (two consumer warpgroups
#: of 64) and keys per step
WG_BQ, WG_BK = 128, 64
_LOG2E = 1.4426950408889634


def flash_tiles_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The wgmma path's arithmetic in plain PyTorch, tile for tile: blocks
    of 128 query rows walk the 64-key tiles that the masks leave live for
    any of their rows; logits in float32 in log2 units, soft-capped as
    ``c * (1 - 2 / (1 + 2^(2 y log2 e)))`` with ``y = x / c`` (the kernel's
    form of tanh); an online max and denominator; P rounded to q's dtype
    before P.V, as the tensor cores take it, and the denominator summing
    the same rounded P; float32 accumulation.  The reference keeps P in
    float32 (``repro/kernels/attention.py:70-75``): this rounding is the
    kernel's one departure from it."""
    check_shapes("flash_tiles_plain", q, k, v)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    s = float(scale if scale is not None else 1.0 / math.sqrt(d))
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    out = torch.empty((b, hq, tq, d), dtype=torch.float32, device=q.device)
    q_offset = tk - tq
    for q0 in range(0, tq, WG_BQ):
        q1 = min(q0 + WG_BQ, tq)
        k_lo, k_hi = 0, tk
        if causal:
            k_hi = min(k_hi, q_offset + q1)
        if window > 0:
            k_lo = max(0, q_offset + q0 - window + 1)
        qpos = torch.arange(q0, q1, device=q.device)[:, None] + q_offset
        m = torch.full((b, hq, q1 - q0, 1), ref.NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hq, q1 - q0, d), device=q.device)
        for k0 in range(k_lo // WG_BK * WG_BK, k_hi if k_hi > k_lo else 0,
                        WG_BK):
            k1 = min(k0 + WG_BK, tk)
            x = ref.torch_matmul(qf[:, :, q0:q1], kf[:, :, k0:k1].mT)
            if softcap > 0.0:
                e = torch.exp2(x * (2.0 * _LOG2E * s / softcap))
                x = (1.0 - 2.0 / (1.0 + e)) * (softcap * _LOG2E)
            else:
                x = x * (s * _LOG2E)
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            live = kpos < tk
            if causal:
                live = live & (qpos >= kpos)
            if window > 0:
                live = live & (qpos - kpos < window)
            x = torch.where(live, x, ref.NEG_INF)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new).to(q.dtype).float()
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + ref.torch_matmul(p, vf[:, :, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D] with Hq % Hkv == 0.
    Query rows are right-aligned to the keys (``q_offset = Tk - Tq``).
    Returns [B, Hq, Tq, D] in q's dtype.  Where q, k or v takes a
    gradient, the call goes through :func:`flash_attention_grad`;
    elsewhere it is the launch alone, by ``gemm.gemm``'s rule."""
    check_shapes("flash_attention", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention_grad(q, k, v, causal, window, softcap, scale)
    return _flash(q, k, v, causal=causal, window=window, softcap=softcap,
                  scale=scale)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int, softcap: float,
           scale: Optional[float]) -> torch.Tensor:
    """The kernel's launch (a CUDA tensor) or its plain version (CPU)."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    check_kernel_inputs("flash_attention", q, k, v)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    s = float(scale if scale is not None else 1.0 / math.sqrt(d))
    out = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    pl = plan(q, k, v)
    q, k, v = (x.contiguous() if c else x for x, c in zip((q, k, v), pl.copy))
    compat.count(globals(), copies=sum(pl.copy), launches=1)
    compat.count(launches_by_path, **{pl.path: 1})
    rc = _entry(pl.path)(
        CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, hq, hkv, tq, tk, d, strides(q, (0, 1, 2)),
        strides(k, (0, 1, 2)), strides(v, (0, 1, 2)), s, float(softcap),
        int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    compat.check(rc, "flash_attention")
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int, softcap: float,
                         scale: Optional[float]) -> torch.Tensor:
    """:func:`flash_attention` as an operator autograd differentiates:
    the forward launches the kernel once, the backward launches none."""
    return _flash(q, k, v, causal=causal, window=window, softcap=softcap,
                  scale=scale)


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, causal, window, softcap, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                  scale=scale)


def _flash_backward(ctx, grad: torch.Tensor):
    """The gradients of the plain formulation, recomputed from q, k, v
    (float32 logits and softmax, as :func:`flash_attention_plain`)."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:3]
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(n) for x, n in zip(saved, need)]
        out = flash_attention_plain(*ins, **ctx.kw)
        got = iter(torch.autograd.grad(
            out, [x for x, n in zip(ins, need) if n], grad))
    return tuple(next(got) if n else None for n in need) + (None,) * 4


flash_attention_grad.register_autograd(_flash_backward,
                                       setup_context=_flash_setup)


@flash_attention_grad.register_fake
def _flash_fake(q, k, v, causal, window, softcap, scale) -> torch.Tensor:
    """The output's shape and dtype without computing it (fake and meta
    tensors: the dry run's sharding propagation)."""
    return q.new_empty(q.shape[:-1] + v.shape[-1:])
