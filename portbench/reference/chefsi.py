"""Plain reference of the CheFSI subspace step, and the inputs both sides
take.

Chebyshev-filtered subspace iteration (Zhou, Saad, Tiago, Chelikowsky,
J. Comput. Phys. 219 (2006) 172-184) is PARSEC's eigensolver.  Each SCF
iteration filters the basis Psi (ngrid x nstates) with a Chebyshev
polynomial of the Hamiltonian H, orthonormalizes it and runs a
Rayleigh-Ritz step.  One step here is the last two on one spin channel's
filtered Psi and H Psi, the orthonormalization in its level-3 form,
Cholesky QR:

    S = Psi^T Psi                       dsyrk
    R = chol(S), S = R^T R              R upper, positive diagonal
    Psi_o = Psi R^-1, HPsi_o = HPsi R^-1   two dtrsm, side R
    Hs = Psi_o^T HPsi_o                 dgemm, K = ngrid
    Hs = Q diag(w) Q^T                  eigh, lower triangle
    Psi_new = Psi_o Q                   dgemm, M = ngrid

H = -1/2 Laplacian + V on a box of ``grid`` points (their product is
ngrid), the 7-point stencil at unit spacing with Dirichlet boundaries,
V uniform on [0, 1) per point and channel.  H enters only through H Psi,
made with the inputs.  Psi is standard normal, standing for the filter's
output.  Step g takes channel g % ``spin_channels``.
"""
from __future__ import annotations

import torch

#: the nearest type below each, for the control
LOWER = {torch.float64: torch.float32}


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def channel_of(cfg: dict, step: int) -> int:
    """The spin channel whose subspace step ``step`` runs."""
    return step % cfg["spin_channels"]


def hamiltonian(psi: torch.Tensor, v: torch.Tensor, grid) -> torch.Tensor:
    """H Psi = -1/2 (7-point Laplacian of Psi) + V Psi for the columns of
    ``psi`` (ngrid x nstates, points in row-major order of ``grid``),
    zero outside the box."""
    nx, ny, nz = grid
    p = psi.view(nx, ny, nz, -1)
    out = psi.mul(v[:, None] + 3.0)               # -1/2 (-6) on the centre
    o = out.view(nx, ny, nz, -1)
    for axis in range(3):
        n = p.shape[axis]
        lo, hi = p.narrow(axis, 0, n - 1), p.narrow(axis, 1, n - 1)
        o.narrow(axis, 1, n - 1).sub_(lo, alpha=0.5)
        o.narrow(axis, 0, n - 1).sub_(hi, alpha=0.5)
    return out


def make_inputs(cfg: dict, traffic: dict, seed: int, device,
                steps=None) -> dict:
    """Each channel's Psi and H Psi on ``device``, from one generator
    seeded with ``seed``: Psi, then V, channel after channel (all of
    them, whatever ``steps``)."""
    ngrid, nstates, dt = cfg["ngrid"], cfg["nstates"], dtype_of(cfg)
    grid = cfg["grid"]
    if grid[0] * grid[1] * grid[2] != ngrid:
        raise ValueError(f"grid {grid} does not hold ngrid {ngrid} points")
    gen = torch.Generator(device=device).manual_seed(seed)
    psi, hpsi = [], []
    for _ in range(cfg["spin_channels"]):
        p = torch.randn(ngrid, nstates, generator=gen, dtype=dt,
                        device=device)
        v = torch.rand(ngrid, generator=gen, dtype=dt, device=device)
        psi.append(p)
        hpsi.append(hamiltonian(p, v, grid))
    return {"psi": psi, "hpsi": hpsi}


def reference(cfg: dict, traffic: dict, inputs: dict, step: int,
              dtype: torch.dtype = None) -> dict:
    """The step's w, R and Psi_new in ``dtype`` (the configuration's by
    default), with the library's product, Cholesky, triangular solves and
    eigh; TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = dtype or dtype_of(cfg)
    ch = channel_of(cfg, step)
    psi = inputs["psi"][ch].to(dt)
    hpsi = inputs["hpsi"][ch].to(dt)
    r = torch.linalg.cholesky(psi.mT @ psi, upper=True)
    psi_o = torch.linalg.solve_triangular(r, psi, upper=True, left=False)
    del psi
    hpsi_o = torch.linalg.solve_triangular(r, hpsi, upper=True, left=False)
    del hpsi
    w, q = torch.linalg.eigh(psi_o.mT @ hpsi_o)
    del hpsi_o
    return {"w": w, "r": r, "psi": psi_o @ q}


def compare(got: dict, want: dict) -> dict:
    """The numbers compared, each the largest error over the largest
    entry of the reference's: w; R (unique, its diagonal positive);
    Psi_new with each column's sign matched to the reference's first."""
    out = {}
    for name in ("w", "r"):
        ref = want[name]
        err = (got[name].to(ref.dtype) - ref).abs().max()
        out[f"{name}_err"] = float(err / ref.abs().max())
    ref = want["psi"]
    psi = got["psi"].to(ref.dtype)
    sign = torch.where((psi * ref).sum(0) < 0, -1.0, 1.0).to(ref.dtype)
    err = (psi * sign - ref).abs().max()
    out["psi_err"] = float(err / ref.abs().max())
    return out
