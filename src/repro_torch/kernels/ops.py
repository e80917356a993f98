"""What the BLAS surface and the model stack call: ``matmul``, ``trsm``,
``syrk`` and ``attention`` on the kernels, and the entry points of the
``pallas`` dispatch venue.

The counterpart of ``repro/kernels/ops.py:59-132`` and ``:135-235``.  The
choice between
the hand-written kernel and its plain version is made by the tensor's
device inside each kernel wrapper (:mod:`repro_torch.kernels.gemm`,
:mod:`repro_torch.kernels.trsm`, :mod:`repro_torch.kernels.syrk`,
:mod:`repro_torch.kernels.attention`,
:mod:`repro_torch.kernels.decode_attention`): a
CUDA tensor launches the kernel, a
CPU tensor takes the plain version.  The shape handling here (batch
broadcasting, complex planes, dtype routing) is the same for both, so the
CPU tests run it.

Complex products use the 4M decomposition onto four real products of the
real and imaginary planes, each plane made contiguous first (``.real``
and ``.imag`` are stride-2 views).  Complex solves and rank-k updates
stay off the kernels, as in the reference: they go to the library
(``ref.trsm``, ``ref.syrk``).

Deliberate difference from the reference: ``ops.py:74-75`` sends real
float64 products to XLA only because the TPU's matrix unit has no
float64.  The H100 has float64 tensor cores and the paper's workloads are
d/zgemm, so here real float64 (and complex128 through its float64
planes) runs on the gemm kernel, which accumulates float64 in float64.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import syrk as syrk_kernel
from repro_torch.kernels import trsm as trsm_kernel
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.gemm import gemm, layout, row_major


def _operand(x: torch.Tensor) -> torch.Tensor:
    """A view the gemm kernel takes as it is: row-major or transposed
    (``gemm.layout``, which the kernel reads as a per-operand transpose
    flag), rows apart.  Only an overlapping or otherwise strided layout is
    copied, so the tied vocab head's ``table.mT`` goes in uncopied."""
    if layout(x) is not None:
        return x
    return x.contiguous()


def _batched(f: Callable, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the 2-D product ``f`` over broadcast leading batch dims as one
    launch.  A stack of activations times one matrix (``x @ W``, every
    projection of the model stack) folds the leading dims into M: one 2-D
    product, and the matrix is never expanded or copied per batch."""
    if a.dim() == 2 and b.dim() == 2:
        return f(_operand(a), _operand(b))
    if b.dim() == 2:
        out = f(_operand(a.reshape(-1, a.shape[-1])), _operand(b))
        return out.reshape(a.shape[:-1] + out.shape[-1:])
    bshape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    af = a.expand(bshape + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    bf = b.expand(bshape + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    out = f(_operand(af), _operand(bf))
    return out.reshape(bshape + out.shape[-2:])


def matmul(a: torch.Tensor, b: torch.Tensor, block: int = 0
           ) -> torch.Tensor:
    """C = A @ B for matrices or stacks of matrices of one dtype.
    ``block`` is the gemm kernel's tile edge (``kernel_block``; 0: each
    path's default)."""
    mm = functools.partial(gemm, block=block) if block else gemm
    if a.is_complex():
        ar, ai = a.real.contiguous(), a.imag.contiguous()
        br, bi = b.real.contiguous(), b.imag.contiguous()
        rr = _batched(mm, ar, br)
        ii = _batched(mm, ai, bi)
        ri = _batched(mm, ar, bi)
        ir = _batched(mm, ai, br)
        return torch.complex(rr - ii, ri + ir).to(a.dtype)
    return _batched(mm, a, b)


def trsm(a: torch.Tensor, b: torch.Tensor, *, side: str = "L",
         uplo: str = "L", trans: str = "N", diag: str = "N"
         ) -> torch.Tensor:
    """Solve op(A) X = B (side L) or X op(A) = B (side R).  Real float32
    and float64 run the kernel recursion; bf16/f16 solve on it in
    float32; complex goes to the library."""
    if a.is_complex() or b.is_complex():
        return ref.trsm(a, b, side=side, uplo=uplo, trans=trans, diag=diag)
    dt = b.dtype
    if dt in (torch.float32, torch.float64):
        return trsm_kernel.trsm(a.to(dt), b, side=side, uplo=uplo,
                                trans=trans, diag=diag)
    x = trsm_kernel.trsm(a.float(), b.float(), side=side, uplo=uplo,
                         trans=trans, diag=diag)
    return x.to(dt)


def _syrk_operand(a: torch.Tensor, trans: str):
    """``(a, trans)`` in a layout the syrk kernel reads uncopied: a
    transposed view of a row-major matrix flips ``trans`` instead of being
    copied; only a layout that is neither gets ``.contiguous()``."""
    if row_major(a):
        return a, trans
    if a.dim() == 2 and row_major(a.mT):
        return a.mT, "T" if trans == "N" else "N"
    return a.contiguous(), trans


def syrk(a: torch.Tensor, *, uplo: str = "L", trans: str = "N"
         ) -> torch.Tensor:
    """C = op(A) op(A)^T, only the ``uplo`` triangle populated.  Real
    types run the syrk kernel; complex goes to the library, as in the
    reference (``repro/kernels/ops.py:105-108``)."""
    if a.is_complex():
        return ref.syrk(a, uplo=uplo, trans=trans)
    a, trans = _syrk_operand(a, trans)
    return syrk_kernel.syrk(a, uplo=uplo, trans=trans)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None, kv_len: Optional[int] = None,
              chunk_q: int = 0) -> torch.Tensor:
    """Attention entry point for the model stack, with the branches of
    ``repro/kernels/ops.py:111-132`` in the same order.  The reference's
    ``use_pallas()`` is the kernel wrapper here, so on the CPU the same
    branch runs that wrapper's plain version:

    * one token (Tq 1) against a cache (``kv_len`` set), causal, no window:
      the decode kernel;
    * Tq >= 8 with no ``kv_len`` (a forward without a cache, or a prefill
      that attends over its fresh keys): the flash kernel;
    * else the query-chunked or the full plain formulation, as the
      reference runs them outside its kernels (the decode steps of
      windowed layers among them)."""
    tq = q.shape[-2]
    if tq == 1 and kv_len is not None and causal and window == 0:
        return decode_attention(q, k, v, kv_len, softcap=softcap,
                                scale=scale)
    if tq >= 8 and kv_len is None:
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    if (chunk_q and causal and window == 0 and kv_len is None
            and tq > chunk_q and tq % chunk_q == 0):
        return ref.attention_chunked(q, k, v, chunk_q=chunk_q,
                                     softcap=softcap, scale=scale)
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale, kv_len=kv_len)


# ---------------------------------------------------------------------------
# The `pallas` dispatch venue (OffloadConfig.kernel_path / SCILIB_KERNELS)
# ---------------------------------------------------------------------------
# `kernel_*` are the entry points behind the runtime's third execution
# venue.  The label stays the reference's, so decisions, counters and
# traces read the same in both packages.  On the card both offload venues
# compute on the hand-written kernels, as both do on a TPU: the `xla`
# venue runs the generic closures of core/blas.py (``matmul`` above, a
# full product masked for syrk), the `pallas` venue the lean closures
# over these entry points (the syrk kernel computes one triangle).  No
# library product enters either venue.  ``block`` is the reference's
# block-edge override (``OffloadConfig.kernel_block``): it picks the gemm
# kernel's tile edge (``gemm.EDGES``) on paths 1, 3 and 4.  The syrk and
# trsm kernels and the fused split kernel have one tile each, so there it
# is inert, as the reference's trsm ignores it.

#: BLAS bases the `pallas` venue can execute; everything else stays on the
#: generic offload path.
KERNEL_BASES = ("gemm", "syrk", "trsm")

#: Bases with a split-precision formulation (kernels/split_gemm.py,
#: SCILIB_PRECISION): fp64 decomposed onto fp32/bf16 slice passes.
SPLIT_KERNEL_BASES = ("gemm", "syrk", "trsm")


def kernel_available(base: str, dtype: torch.dtype,
                     precision: str = "") -> bool:
    """Capability test for the `pallas` venue, the reference's matrix
    exactly (``repro/kernels/ops.py:156-172``): complex syrk/trsm have no
    kernel, complex gemm runs 4M, and an fp64 gemm counts as a kernel
    only with a split scheme.  Without one an fp64 gemm still runs the
    gemm kernel, on the `xla` venue, so decisions and counters match the
    reference's."""
    if base not in KERNEL_BASES:
        return False
    if dtype.is_complex:
        return base == "gemm"
    if dtype == torch.float64 and base == "gemm":
        return bool(precision) and base in SPLIT_KERNEL_BASES
    return True


def kernel_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  block: int = 0) -> torch.Tensor:
    """C = A @ B on the `pallas` venue: :func:`matmul` with the tile edge
    ``block``.  A split fp64 product on this venue does not come here:
    the runtime's precision stage builds it from
    ``core/blas.py:_split_matmul``, which runs the fused split kernel
    (:mod:`repro_torch.kernels.split_gemm`)."""
    return matmul(a, b, block)


def kernel_syrk(a: torch.Tensor, *, uplo: str = "L", trans: str = "N",
                block: int = 0) -> torch.Tensor:
    """C = op(A) op(A)^T on the `pallas` venue (the syrk kernel; complex
    on the library, which ``kernel_available`` already refuses)."""
    del block   # the syrk kernel has one tile edge
    return syrk(a, uplo=uplo, trans=trans)


def kernel_trsm(a: torch.Tensor, b: torch.Tensor, *, side: str = "L",
                uplo: str = "L", trans: str = "N", diag: str = "N",
                block: int = 0) -> torch.Tensor:
    """The triangular solve on the `pallas` venue: the trsm kernel
    recursion (complex on the library, as :func:`trsm`)."""
    del block   # the recursion's base edge is fixed (trsm.BASE)
    return trsm(a, b, side=side, uplo=uplo, trans=trans, diag=diag)
