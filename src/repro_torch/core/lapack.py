"""Blocked LAPACK routines built on the intercepted BLAS (paper §4.2).

The port's counterpart of ``repro/core/lapack.py``.  MuST's hot path is
LU factorization and solve (``zgetrf``/``zgetrs``), whose inner loops are
the very ``zgemm``/``ztrsm`` calls SCILIB-Accel offloads.  This module
reproduces that call structure: right-looking blocked LU with partial
pivoting, triangular solves and blocked Cholesky.  Every panel update
goes through :mod:`repro_torch.core.blas`, so an active offload runtime
sees exactly the BLAS stream a LAPACK-linked binary would emit.

These are eager, host-orchestrated drivers, like LAPACK itself: Python
plays the Fortran driver, the FLOPs are in the BLAS calls.  The reference
is functional; here the LU factor is a clone of the input, updated in
place, and the Cholesky factor a fresh tensor, both on the input's device.
The unblocked panel (:func:`_pivot_panel`) runs on that device with no
host synchronization per column; its pivots come to the host once per
panel.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core import blas
from repro_torch.core import runtime as rtm

DEFAULT_NB = 128

_PREC = {torch.float32: "s", torch.float64: "d",
         torch.complex64: "c", torch.complex128: "z"}


def _prec(dtype: torch.dtype) -> str:
    return _PREC.get(dtype, "d")


def _note_panel(prec: str, m: int, nb: int, panel: torch.Tensor) -> None:
    """Report an unblocked panel factorization to the active runtime.
    Inside a solver span (:mod:`repro_torch.solvers`) it counts toward the
    span's panel share and appears as a ``getf2`` trace call; outside a
    span it is a no-op."""
    rt = rtm.active()
    if rt is not None:
        rt.note_panel(prec, m, nb, panel)


def _pivot_panel(p: torch.Tensor) -> List[int]:
    """Unblocked LU with partial pivoting of an (m x nb) panel, in place
    (``repro/core/lapack.py:45-81``).

    Per column j: the pivot is the first row at or below j of largest
    modulus (``jnp.argmax`` of ``abs``, first index on ties), rows j and
    the pivot swap, the column below j is scaled by the pivot's
    reciprocal (0 for a zero pivot), and the trailing panel columns take
    the rank-1 update.  Everything stays on the panel's device; the
    panel's local pivots come back to the host in one copy."""
    m, nb = p.shape
    rows = torch.arange(m, device=p.device)
    piv = torch.empty(nb, dtype=torch.int64, device=p.device)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    for j in range(nb):
        r = torch.argmax(p[j:, j].abs()) + j
        piv[j] = r
        pair = torch.stack((rows[j], r))
        p.index_copy_(0, pair.flip(0), p.index_select(0, pair))
        pivval = p[j, j]
        scale = torch.where(pivval != 0, pivval.reciprocal(), zero)
        col = p[j + 1:, j]
        col.mul_(scale)
        p[j + 1:, j + 1:].sub_(col[:, None] * p[j, j + 1:][None, :])
    return piv.tolist()


def getrf(a: torch.Tensor, nb: int = DEFAULT_NB
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked right-looking LU with partial pivoting (general m x n).

    Returns ``(LU, piv)``: ``piv`` (int32, on the factor's device) is the
    absolute row permutation (length ``m``) with ``A[piv] == L @ U``, the
    composed form of LAPACK's sequential ipiv swaps.  The trailing-matrix
    updates are the trsm + gemm pairs that dominate MuST's runtime."""
    m, n = a.shape
    prec = _prec(a.dtype)
    k_max = min(m, n)
    lu = a.clone(memory_format=torch.contiguous_format)
    piv = list(range(m))
    for j0 in range(0, k_max, nb):
        jb = min(nb, k_max - j0)
        panel = lu[j0:, j0:j0 + jb]
        lpiv = _pivot_panel(panel)
        _note_panel(prec, m - j0, jb, panel)
        # compose the panel's swaps into one permutation of rows j0:
        perm = list(range(m - j0))
        for jj, r in enumerate(lpiv):
            perm[jj], perm[r] = perm[r], perm[jj]
        piv[j0:] = [piv[j0 + r] for r in perm]
        # the panel's rows are swapped already: permute the rows of the
        # columns left and right of it
        if perm != list(range(m - j0)):
            idx = torch.tensor(perm, dtype=torch.int64, device=lu.device)
            for cols in (slice(0, j0), slice(j0 + jb, n)):
                blk = lu[j0:, cols]
                if blk.numel():
                    blk.copy_(blk.index_select(0, idx))
        if j0 + jb < n:
            # U12 = L11^{-1} A12           (trsm, unit lower)
            l11 = lu[j0:j0 + jb, j0:j0 + jb]
            a12 = lu[j0:j0 + jb, j0 + jb:]
            u12 = blas.trsm(l11, a12, side="L", uplo="L", trans="N",
                            diag="U")
            a12.copy_(u12)
            if j0 + jb < m:
                # A22 -= L21 U12           (gemm: the hot spot)
                l21 = lu[j0 + jb:, j0:j0 + jb]
                a22 = lu[j0 + jb:, j0 + jb:]
                upd = blas.gemm(l21, u12, a22, alpha=-1.0, beta=1.0)
                a22.copy_(upd)
    return lu, torch.tensor(piv, dtype=torch.int32, device=lu.device)


def _as_matrix(b: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    return (b[:, None], True) if b.dim() == 1 else (b, False)


def getrs(lu: torch.Tensor, piv: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Solve A X = B from getrf output (the row permutation + two trsm
    calls): A x = b  <=>  LU x = b[piv]."""
    b, squeeze = _as_matrix(b)
    x = b.index_select(0, piv.to(device=b.device, dtype=torch.int64))
    y = blas.trsm(lu, x, side="L", uplo="L", trans="N", diag="U")
    z = blas.trsm(lu, y, side="L", uplo="U", trans="N", diag="N")
    return z[:, 0] if squeeze else z


def gesv(a: torch.Tensor, b: torch.Tensor,
         nb: int = DEFAULT_NB) -> torch.Tensor:
    """Driver: solve A X = B (the zgetrf + zgetrs pair MuST calls)."""
    lu, piv = getrf(a, nb=nb)
    return getrs(lu, piv, b)


def _conj_t(a: torch.Tensor) -> torch.Tensor:
    """A^H as a contiguous tensor with its conjugation applied (never a
    lazily conjugated view, which the kernels would read unconjugated)."""
    return a.mH.resolve_conj().contiguous()


def _chol_block(blk: torch.Tensor) -> torch.Tensor:
    """Unblocked Cholesky of a diagonal block on the *native*
    ``torch.linalg.cholesky``, also while the solver tier has patched it
    (a block at or above the threshold would otherwise re-enter
    :func:`potrf` without end).  The block is symmetrized first, as
    ``jnp.linalg.cholesky`` does with its input."""
    from repro_torch.solvers.intercept import native
    return native("cholesky")((blk + blk.mH) / 2)


def potrf(a: torch.Tensor, nb: int = DEFAULT_NB, *,
          uplo: str = "L") -> torch.Tensor:
    """Blocked Cholesky (gemm updates + right-side trsm + an unblocked
    diagonal block) of a real-symmetric or complex-Hermitian matrix.
    ``uplo="U"`` factors the conjugate transpose and returns ``U`` with
    ``A = U^H U``."""
    if uplo == "U":
        return _conj_t(potrf(_conj_t(a), nb, uplo="L"))
    n = a.shape[0]
    l = torch.zeros_like(a, memory_format=torch.contiguous_format)
    for j0 in range(0, n, nb):
        jb = min(nb, n - j0)
        # diagonal block: A11 - L10 L10^H
        l10 = l[j0:j0 + jb, :j0]
        a11 = a[j0:j0 + jb, j0:j0 + jb]
        if j0 > 0:
            a11 = blas.gemm(l10, l10, a11, alpha=-1.0, beta=1.0,
                            trans_b="C")
        l11 = _chol_block(a11)
        l[j0:j0 + jb, j0:j0 + jb] = l11
        if j0 + jb < n:
            l20 = l[j0 + jb:, :j0]
            a21 = a[j0 + jb:, j0:j0 + jb]
            if j0 > 0:
                a21 = blas.gemm(l20, l10, a21, alpha=-1.0, beta=1.0,
                                trans_b="C")
            # L21 = A21 L11^{-H}    (right-side trsm)
            l21 = blas.trsm(l11, a21, side="R", uplo="L", trans="C",
                            diag="N")
            l[j0 + jb:, j0:j0 + jb] = l21
    return l


def potrs(f: torch.Tensor, b: torch.Tensor, *,
          uplo: str = "L") -> torch.Tensor:
    """Solve A X = B from potrf output (two triangular solves)."""
    b, squeeze = _as_matrix(b)
    if uplo == "L":
        # A = L L^H: solve L y = b, then L^H x = y
        y = blas.trsm(f, b, side="L", uplo="L", trans="N", diag="N")
        x = blas.trsm(f, y, side="L", uplo="L", trans="C", diag="N")
    else:
        # A = U^H U: solve U^H y = b, then U x = y
        y = blas.trsm(f, b, side="L", uplo="U", trans="C", diag="N")
        x = blas.trsm(f, y, side="L", uplo="U", trans="N", diag="N")
    return x[:, 0] if squeeze else x
