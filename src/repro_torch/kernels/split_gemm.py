"""Split-precision fp64 GEMM for the `pallas` dispatch venue.

The counterpart of ``repro/kernels/split_gemm.py``.
:mod:`repro_torch.core.precision` owns the decomposition math (slices,
cross passes, error bounds); this module binds its injectable fp32 pass
primitive to the hand-written gemm kernel (``csrc/gemm.cu``) with a
float32 output: the fp64 operands never reach the kernel, their fp32
slices do, and the fp64 re-accumulation runs outside it.  The kernel
computes float32 in IEEE FMAs (no TF32), which the split bounds assume.

On a CPU tensor the pass takes the gemm kernel's plain version, like
every kernel wrapper of the port, so the venue's split path runs in the
CPU tests too.
"""
from __future__ import annotations

import torch

from repro_torch.core import precision
from repro_torch.kernels import gemm

#: pass launches of the gemm kernel (CUDA tensors) since the last reset
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One fp32 slice product on the gemm kernel, written in float32; an
    empty contraction (k = 0) is zeros without a launch."""
    if a.shape[-1] == 0:
        return torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                           device=a.device)
    global launches
    before = gemm.launches
    out = gemm.gemm(a, b, out_dtype=torch.float32)
    launches += gemm.launches - before
    return out


def pass_mm() -> precision.MatMul:
    """The fp32 slice-product primitive for the `pallas` venue."""
    return _mm


def matmul(a: torch.Tensor, b: torch.Tensor, scheme: str) -> torch.Tensor:
    """fp64 ``A @ B`` via split slices on the gemm kernel."""
    return precision.matmul(a, b, scheme, mm=pass_mm())


def syrk(a: torch.Tensor, scheme: str, *, trans: bool = False
         ) -> torch.Tensor:
    return precision.syrk(a, scheme, trans=trans, mm=pass_mm())


def trsm(a: torch.Tensor, b: torch.Tensor, scheme: str, *,
         left_side: bool = True, lower: bool = True, trans_a: bool = False,
         unit_diag: bool = False) -> torch.Tensor:
    return precision.trsm(a, b, scheme, left_side=left_side, lower=lower,
                          trans_a=trans_a, unit_diag=unit_diag,
                          mm=pass_mm())
