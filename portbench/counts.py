"""Operations and bytes of the benchmark's BLAS and LAPACK calls, counted
from their shapes, and the peaks of one NVIDIA H100 that bound them.

A frozen yardstick: the peaks are the data sheet's (SXM part, dense, at
its 700 W limit), and each count is what the call needs, not what a
kernel happens to do, so a share of these bounds stays the same whatever
kernel implements the call.  A bound is ``max(operations / peak,
bytes / bandwidth)``, with each operand read once and the result written
once.
"""
from __future__ import annotations

#: float64 (and float32 outside the tensor cores) FLOP/s of one H100
F64_PEAK = 67e12
#: HBM3 bytes/s of one H100
HBM_BYTES_PER_S = 3.35e12

ITEMSIZE = {"float32": 4, "float64": 8, "complex64": 8, "complex128": 16}
#: real operations per multiply-add of the type, over a real one's 2
_MULT = {"float32": 1, "float64": 1, "complex64": 4, "complex128": 4}


def _check(dtype: str) -> None:
    if dtype not in ITEMSIZE:
        raise ValueError(f"no counts for dtype {dtype!r}; "
                         f"choose from {sorted(ITEMSIZE)}")


def gemm(m: int, n: int, k: int, dtype: str) -> tuple:
    """(operations, bytes) of C = A B with A m x k and B k x n."""
    _check(dtype)
    flops = 2.0 * m * n * k * _MULT[dtype]
    nbytes = float(ITEMSIZE[dtype]) * (m * k + k * n + m * n)
    return flops, nbytes


def syrk(n: int, k: int, dtype: str) -> tuple:
    """(operations, bytes) of one triangle of C = op(A) op(A)^T, C n x n,
    over k: n(n+1)k real operations, A read once and C written once."""
    _check(dtype)
    flops = float(n) * (n + 1) * k * _MULT[dtype]
    nbytes = float(ITEMSIZE[dtype]) * (n * k + n * n)
    return flops, nbytes


def getrf(n: int, dtype: str) -> float:
    """Operations of an n x n LU factorization: 2n^3/3 real (8n^3/3
    complex)."""
    _check(dtype)
    return 2.0 * n ** 3 / 3.0 * _MULT[dtype]


def getrs(n: int, nrhs: int, dtype: str) -> float:
    """Operations of the two triangular solves against nrhs columns:
    2 n^2 nrhs real (8 n^2 nrhs complex)."""
    _check(dtype)
    return 2.0 * n * n * nrhs * _MULT[dtype]


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds one H100 needs for the work: the larger of its
    operations at the float64 peak and its bytes at HBM bandwidth."""
    return max(flops / F64_PEAK, nbytes / HBM_BYTES_PER_S)
