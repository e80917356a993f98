"""What the BLAS surface calls: ``matmul`` and ``trsm`` on the kernels.

The counterpart of ``repro/kernels/ops.py:59-102``.  The choice between
the hand-written kernel and its plain version is made by the tensor's
device inside each kernel wrapper (:mod:`repro_torch.kernels.gemm`,
:mod:`repro_torch.kernels.trsm`): a CUDA tensor launches the kernel, a
CPU tensor takes the plain version.  The shape handling here (batch
broadcasting, complex planes, dtype routing) is the same for both, so the
CPU tests run it.

Complex products use the 4M decomposition onto four real products of the
real and imaginary planes, each plane made contiguous first (``.real``
and ``.imag`` are stride-2 views).  Complex solves stay off the kernel,
as in the reference: they go to the library (``ref.trsm``).

Deliberate difference from the reference: ``ops.py:74-75`` sends real
float64 products to XLA only because the TPU's matrix unit has no
float64.  The H100 has float64 tensor cores and the paper's workloads are
d/zgemm, so here real float64 (and complex128 through its float64
planes) runs on the gemm kernel, which accumulates float64 in float64.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import trsm as trsm_kernel
from repro_torch.kernels.gemm import gemm, row_major


def _rowmajor(x: torch.Tensor) -> torch.Tensor:
    """A view the gemm kernel takes (unit column stride, rows apart),
    copying only when the layout is transposed or overlapping."""
    if row_major(x) and (x.dim() < 3 or x.shape[0] <= 1
                         or x.stride(0) >= x.shape[-2] * x.shape[-1]):
        return x
    return x.contiguous()


def _batched(f: Callable, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the 2-D product ``f`` over broadcast leading batch dims as one
    batched launch."""
    if a.dim() == 2 and b.dim() == 2:
        return f(_rowmajor(a), _rowmajor(b))
    bshape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    af = a.expand(bshape + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    bf = b.expand(bshape + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    out = f(_rowmajor(af), _rowmajor(bf))
    return out.reshape(bshape + out.shape[-2:])


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B for matrices or stacks of matrices of one dtype."""
    if a.is_complex():
        ar, ai = a.real.contiguous(), a.imag.contiguous()
        br, bi = b.real.contiguous(), b.imag.contiguous()
        rr = _batched(gemm, ar, br)
        ii = _batched(gemm, ai, bi)
        ri = _batched(gemm, ar, bi)
        ir = _batched(gemm, ai, br)
        return torch.complex(rr - ii, ri + ir).to(a.dtype)
    return _batched(gemm, a, b)


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
