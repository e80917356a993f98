"""PARSEC proxy (paper §4.3), on PyTorch.

The port's counterpart of ``repro/apps/dft.py``.  PARSEC does real-space
DFT: Chebyshev-filtered subspace iteration over a finite-difference
Hamiltonian on ~93k grid points.  The ScaLAPACK layer reduces to
*extremely tall-skinny* dgemms — the paper's canonical shape is
``transA='T', M=32, N=2400, K=93536``: a 24 MB block of the wavefront
against the 1.8 GB wavefunction panel.

``production_trace`` reproduces that stream for the Table 5 replay;
``run_mini`` runs a real (downscaled) subspace iteration through the
interception layer, with a Rayleigh-Ritz step whose eigenvalues are
verifiable against dense numpy.  Its Hamiltonian is dense (ngrid^2), so
it stays mini; the production shapes are driven through the BLAS surface
(``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import memspace
from repro_torch.core.trace import Trace
from repro_torch.solvers.intercept import native

# Production shape (paper §4.3 / Table 6 row 4)
PROD = dict(ngrid=93536, nstates=2400, nblock=32, scf=2, filt_per_scf=9)


def production_trace(ngrid: int = PROD["ngrid"],
                     nstates: int = PROD["nstates"],
                     nblock: int = PROD["nblock"],
                     scf: int = PROD["scf"],
                     filt_per_scf: int = PROD["filt_per_scf"]) -> Trace:
    """Single-node PARSEC BLAS stream (Table 5 workload).

    Per filter sweep, each of the nstates/nblock wavefront blocks hits
    the resident wavefunction panel: dgemm^T (nblock x nstates x ngrid).
    The panel buffer (1.8 GB) is reused by every call, while block
    operands rotate through a small working set.
    """
    t = Trace()
    el = 8
    psi = t.new_buffer(ngrid * nstates * el, "psi_panel")      # 1.8 GB
    nblocks = max(1, nstates // nblock)
    work = [t.new_buffer(ngrid * nblock * el, f"hpsi_blk{i}")  # 24 MB
            for i in range(nblocks)]
    outs = [t.new_buffer(nblock * nstates * el, f"s_blk{i}")   # 0.6 MB
            for i in range(nblocks)]
    for _ in range(scf):
        for _f in range(filt_per_scf):
            for blk in range(nblocks):
                for _r in range(46):   # orthogonalization sub-iterations
                    # S_blk = Hpsi_blk^T @ Psi  (M=32, N=2400, K=93536)
                    t.gemm("d", nblock, nstates, ngrid,
                           work[blk], psi, outs[blk])
    return t


def run_mini(ngrid: int = 2048, nstates: int = 48, cheb_order: int = 10,
             scf: int = 8, seed: int = 0, device=None) -> Dict[str, float]:
    """Downscaled Chebyshev-filtered subspace iteration (CheFSI).

    H = 1-D Laplacian + random potential (real spectrum).  The filter
    window [lo, hi] brackets the unwanted upper spectrum and adapts each
    pass from the Ritz values, as in PARSEC.  Verifies the converged
    Ritz values against dense eigh.  The products ``H @ psi`` and
    ``psi^T H psi`` go through the public symbols (intercepted dgemms
    under an open session); QR and eigh are PyTorch's own, as the
    reference leaves them to XLA: the eigh is the native one also while a
    ``lapack`` session has patched ``torch.linalg.eigh``, so this loop
    opens no solver span.  ``device=None`` runs on ``cuda:0`` and
    raises without CUDA; ``device="cpu"`` runs on the CPU.  The inputs
    are drawn with numpy from ``seed`` in the reference's order.
    """
    dev = memspace.resolve_device(device)
    rng = np.random.default_rng(seed)
    # finite-difference H: tridiagonal Laplacian + potential
    pot = 0.5 * rng.standard_normal(ngrid)
    h = (np.diag(2.0 + pot) + np.diag(-np.ones(ngrid - 1), 1)
         + np.diag(-np.ones(ngrid - 1), -1))
    hj = torch.as_tensor(h, device=dev)

    psi = torch.as_tensor(rng.standard_normal((ngrid, nstates)), device=dev)
    psi, _ = torch.linalg.qr(psi)
    hi = float(2.0 + np.max(pot) + 2.0) + 0.5    # Gershgorin upper bound

    def rayleigh_ritz(p):
        hpsi = torch.matmul(hj, p)                 # (ngrid, nstates)
        s = torch.einsum("gi,gj->ij", p, hpsi)     # skinny^T x panel
        # the native eigh, also under a lapack session: the reference's
        # jnp.linalg.eigh is not a symbol its solver tier patches
        evals, vecs = native("eigh")((s + s.T) / 2.0)
        return torch.matmul(p, vecs), evals

    psi, ritz = rayleigh_ritz(psi)                 # bootstrap the window
    for _ in range(scf):
        lo = min(float(ritz[-1]) + 0.2, hi - 1.0)  # damp above block
        c, e = (hi + lo) / 2.0, (hi - lo) / 2.0
        t0 = psi
        t1 = (torch.matmul(hj, psi) - c * psi) / e
        for _k in range(cheb_order - 1):
            t0, t1 = t1, 2.0 * (torch.matmul(hj, t1) - c * t1) / e - t0
        psi, _ = torch.linalg.qr(t1)
        psi, ritz = rayleigh_ritz(psi)
    exact = np.linalg.eigvalsh(h)[:nstates]
    ritz = ritz.cpu().numpy()
    err = float(np.max(np.abs(ritz[:nstates // 2] - exact[:nstates // 2])))
    return {"ritz_min": float(ritz[0]), "exact_min": float(exact[0]),
            "max_err_low_half": err}
