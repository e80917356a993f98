"""Operations and bytes of the CheFSI step's calls that
:mod:`portbench.counts` does not count: the triangular solve, the
Cholesky factorization and the symmetric eigensolver, from their shapes,
bounded by the same H100 peaks.

Each count is what the call needs, as :mod:`portbench.counts` counts: a
frozen yardstick, whatever kernel or library runs the call.
"""
from __future__ import annotations

from portbench.counts import ITEMSIZE, _MULT, _check, gemm, syrk


def trsm(m: int, n: int, dtype: str) -> tuple:
    """(operations, bytes) of X op(A) = B with B and X m x n and A an
    n x n triangle (side R; side L is the same with m and n swapped):
    m n^2 real operations (n^2 multiply-adds a row, LAPACK Working Note
    41's count for xTRSM with side R), the triangle and B read once and
    X written once."""
    _check(dtype)
    flops = float(m) * n * n * _MULT[dtype]
    nbytes = float(ITEMSIZE[dtype]) * (n * (n + 1) // 2 + 2 * m * n)
    return flops, nbytes


def potrf(n: int, dtype: str) -> float:
    """Operations of an n x n Cholesky factorization: n^3/3 real (LAPACK
    Working Note 41, xPOTRF: n^3/6 multiplications and n^3/6
    additions, leading terms)."""
    _check(dtype)
    return n ** 3 / 3.0 * _MULT[dtype]


def eigh(n: int, dtype: str) -> float:
    """Operations of an n x n symmetric eigendecomposition, eigenvectors
    included, by reduction to tridiagonal form and back: 4n^3/3 for the
    reduction (LAPACK Working Note 41, xSYTRD: 2n^3/3 multiplications
    and 2n^3/3 additions) and 2n^3 for applying its reflectors to the
    n eigenvectors (xORMTR, side L, m = n = k); the tridiagonal solve's
    O(n^2) work is left out."""
    _check(dtype)
    return (4.0 / 3.0 + 2.0) * n ** 3 * _MULT[dtype]


def step(ngrid: int, nstates: int, dtype: str) -> float:
    """Operations of one subspace step: the Gram matrix (syrk), its
    Cholesky factor, two side-R solves, Hs (K = ngrid), eigh and the
    rotation Psi_o Q (M = ngrid)."""
    n, k = nstates, ngrid
    return (syrk(n, k, dtype)[0] + potrf(n, dtype)
            + 2 * trsm(k, n, dtype)[0] + gemm(n, n, k, dtype)[0]
            + eigh(n, dtype) + gemm(k, n, n, dtype)[0])
