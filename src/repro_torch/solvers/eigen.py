"""Blocked Hermitian eigensolver (syev/heev) on the intercepted BLAS.

The port's counterpart of ``repro/solvers/eigen.py``: LAPACK's one-stage
``?sytrd``/``?hetrd`` structure.  latrd panels build ``kb`` Householder
reflectors at a time (each column costs one big symmetric/Hermitian
matvec through :mod:`repro_torch.core.blas` plus small V/W corrections),
the trailing submatrix takes one rank-2k ``syr2k``/``her2k`` per panel,
the real tridiagonal system is solved on the host, and the eigenvectors
are back-transformed panel by panel with compact-WY gemms.

Only the lower triangle of the working matrix is referenced and updated
(``uplo="U"`` inputs are mirrored up front).  The small products (the V/W
corrections, the kb x kb T apply) use the plain product
:data:`repro_torch.kernels.ref.torch_matmul`: they are not BLAS calls in
the reference either (a ``jax.Array @`` is not intercepted there), so the
counters carry no gemv rows the reference lacks.  ``larft`` runs in numpy
on the host, as in the reference.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import blas
from repro_torch.core.lapack import DEFAULT_NB
from repro_torch.kernels.ref import torch_matmul as _mm


def _hermitize(a: torch.Tensor, uplo: str) -> torch.Tensor:
    """Full Hermitian matrix from the referenced triangle (the other
    triangle of a LAPACK-convention input may hold garbage)."""
    tri = torch.triu(a, 1) if uplo == "U" else torch.tril(a, -1)
    dg = torch.diagonal(a).real.to(a.dtype)
    return tri + tri.mH.resolve_conj() + torch.diag(dg)


def _larfg(alpha: complex, x: torch.Tensor, iscomplex: bool
           ) -> Tuple[float, torch.Tensor, complex]:
    """Elementary reflector (zlarfg): returns ``(beta, v, tau)`` with
    ``beta`` real, ``v[0] == 1`` and
    ``(I - tau v v^H)^H [alpha; x] = [beta; 0]``."""
    a = complex(alpha)
    xnorm = float(torch.linalg.vector_norm(x)) if x.numel() else 0.0
    one = torch.ones(1, dtype=x.dtype, device=x.device)
    if xnorm == 0.0 and a.imag == 0.0:
        # already real-tridiagonal here: H = I
        return a.real, torch.cat([one, x]), 0j if iscomplex else 0.0
    beta = -math.copysign(
        math.sqrt(a.real * a.real + a.imag * a.imag + xnorm * xnorm),
        a.real)
    tau = (beta - a) / beta
    scale = 1.0 / (a - beta)
    if not iscomplex:             # exact: a.imag == 0 on the real path
        tau, scale = tau.real, scale.real
    return beta, torch.cat([one, x * scale]), tau


def _sytrd(a: torch.Tensor, nb: int
           ) -> Tuple[np.ndarray, np.ndarray, List[tuple]]:
    """Blocked lower tridiagonalization ``A = Q T Q^H``.

    Returns ``(d, e, panels)``: the real tridiagonal (host numpy) and per
    panel ``(k0, V, taus)`` for the back-transform.  The latrd matvec
    reads the (not yet updated) trailing block through ``symm``/``hemm``
    and the deferred rank-2k update writes the lower triangle through
    ``syr2k``/``her2k``, one level-3 call per panel.  ``a`` is updated in
    place."""
    n = a.shape[0]
    dtype, dev = a.dtype, a.device
    iscomplex = dtype.is_complex
    matvec = blas.hemm if iscomplex else blas.symm
    rank2 = blas.her2k if iscomplex else blas.syr2k
    d = np.zeros(n)
    e = np.zeros(max(0, n - 1))
    panels: List[tuple] = []
    k0 = 0
    while n - k0 > 1:
        m = n - k0
        kb = min(nb, m - 1)
        a2 = a[k0:, k0:]
        V = torch.zeros((m, kb), dtype=dtype, device=dev)
        W = torch.zeros((m, kb), dtype=dtype, device=dev)
        taus: List[complex] = []
        for j in range(kb):
            # column j under the panel's previous reflectors (deferred
            # update: A - V W^H - W V^H); rows < j are never read
            col = (a2[:, j] - _mm(V, W[j, :].conj())
                   - _mm(W, V[j, :].conj()))
            d[k0 + j] = float(col[j].real)
            beta, v, tau = _larfg(col[j + 1].item(), col[j + 2:],
                                  iscomplex)
            e[k0 + j] = beta
            taus.append(tau)
            V[j + 1:, j] = v
            vfull = torch.zeros(m, dtype=dtype, device=dev)
            vfull[j + 1:] = v
            # w = tau (A v - V(W^H v) - W(V^H v)) - (tau/2)(w^H v) v;
            # the big matvec runs on the pre-panel trailing block
            p = matvec(a2, vfull[:, None], side="L", uplo="L")[:, 0]
            p = (p - _mm(V, _mm(W.mH, vfull))
                 - _mm(W, _mm(V.mH, vfull)))
            w = tau * p
            w[:j + 1] = 0
            w = w + (-0.5 * tau * _mm(w.conj(), vfull)) * vfull
            W[:, j] = w
        panels.append((k0, V, taus))
        if k0 + kb < n:
            # the deferred rank-2k trailing update: the panel's one
            # level-3 call, and the offload runtime's hot spot here
            trail = a[k0 + kb:, k0 + kb:]
            upd = rank2(V[kb:, :], W[kb:, :], trail, uplo="L", trans="N",
                        alpha=-1.0, beta=1.0)
            trail.copy_(upd)
        k0 += kb
    if k0 < n:
        d[n - 1] = float(a[n - 1, n - 1].real)
    return d, e, panels


def _tridiag_eigh(d: np.ndarray, e: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Host eigensolve of the real tridiagonal (O(n) data, far below any
    offload threshold, where LAPACK keeps it too)."""
    from scipy.linalg import eigh_tridiagonal
    return eigh_tridiagonal(d, e)


def _larft(V: torch.Tensor, taus: List[complex]) -> np.ndarray:
    """Compact-WY triangular factor of the forward product
    ``H_0 H_1 ... H_{kb-1} = I - V T V^H`` (larft, forward/columnwise;
    kb x kb, built on the host)."""
    kb = len(taus)
    Vn = V.cpu().numpy()
    T = np.zeros((kb, kb), dtype=Vn.dtype)
    for j, tau in enumerate(taus):
        if j > 0:
            T[:j, j] = -tau * (T[:j, :j]
                               @ (Vn[:, :j].conj().T @ Vn[:, j]))
        T[j, j] = tau
    return T


def _apply_q(panels: List[tuple], z: np.ndarray, dtype,
             device) -> torch.Tensor:
    """Back-transform ``S = Q Z``: the panel products in reverse order,
    each as two big gemms around a small T application."""
    s = torch.as_tensor(z, dtype=dtype, device=device).contiguous()
    for k0, V, taus in reversed(panels):
        T = torch.as_tensor(_larft(V, taus), dtype=dtype, device=device)
        s2 = s[k0:, :]
        x = blas.gemm(V, s2, trans_a="C")       # V^H S
        x = _mm(T, x)                           # small kb x kb apply
        s2.copy_(blas.gemm(V, x, s2, alpha=-1.0, beta=1.0))
    return s


def syev(a: torch.Tensor, nb: int = DEFAULT_NB, *,
         uplo: str = "L") -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a Hermitian matrix: ``A = S diag(w) S^H``.
    Returns ``(w, S)`` with ``w`` real ascending and ``S`` the eigenvector
    columns, as ``torch.linalg.eigh`` does."""
    n = a.shape[0]
    dtype, dev = a.dtype, a.device
    rdtype = torch.empty(0, dtype=dtype).real.dtype
    if n == 0:
        return (torch.zeros(0, dtype=rdtype, device=dev),
                torch.zeros((0, 0), dtype=dtype, device=dev))
    if n == 1:
        return (a[0, 0].real.to(rdtype).reshape(1),
                torch.ones((1, 1), dtype=dtype, device=dev))
    full = _hermitize(a, uplo)
    d, e, panels = _sytrd(full, nb=max(1, nb))
    w, z = _tridiag_eigh(d, e)
    s = _apply_q(panels, z, dtype, dev)
    return torch.as_tensor(w, dtype=rdtype, device=dev), s
