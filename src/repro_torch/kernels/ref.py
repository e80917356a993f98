"""Plain PyTorch versions of the functions the port's kernels compute.

The counterparts of ``repro/kernels/ref.py``: the ground truth the kernel
tests compare against, and the library calls for the work the reference
also leaves outside its kernels (complex trsm and syrk, the residual
check).

``torch.matmul`` is captured when this module is imported, before any
session patches the public symbols, so nothing here re-enters the
interceptor (``repro_torch.core.intercept``).
"""
from __future__ import annotations

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
