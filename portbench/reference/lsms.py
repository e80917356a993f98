"""Plain reference of the LSMS step, and the inputs both sides take.

One step is one KKR solve of multiple-scattering theory (MuST/LSMS, arXiv
2501.00279 section 4.2) for an (atom, energy) pair:

    tG = t @ G_atom          the structure constants G are fixed per atom
    M = I - z tG             z = 0.1 + 0.05 e + 0.02i at energy point e
    tau = M^-1 t[:, :nrhs]   LU with partial pivoting, then two solves
    energy = trace(tau) / n

The inputs are drawn as the repository's LSMS proxy draws them:
G = (X + iY) / (2n) with X, Y standard normal, and t = I + 0.01 X, real.
A pool of ``tpool`` t-matrices stands for the energy-dependent t of each
step, which would not fit the card one per step.  The loop order is SCF,
then energies, then atoms, so step g solves atom g % atoms at energy
(g // atoms) % energies with t-matrix g % tpool.
"""
from __future__ import annotations

import math

import torch

#: the nearest type below each, for the control
LOWER = {torch.complex128: torch.complex64, torch.float64: torch.float32}


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def make_inputs(cfg: dict, traffic: dict, seed: int, device,
                steps=None) -> dict:
    """G for each atom (a list, one draw an atom) and the t-matrix pool,
    on ``device``, from one generator seeded with ``seed``.  Given
    ``steps``, only the G's of those steps' atoms are kept (the others
    are drawn and dropped, so the draws stay the same): None in their
    place."""
    n, atoms, pool = cfg["n"], cfg["atoms_per_node"], cfg["tpool"]
    dt = dtype_of(cfg)
    keep = (set(range(atoms)) if steps is None
            else {schedule(cfg, s)[0] for s in steps})
    gen = torch.Generator(device=device).manual_seed(seed)
    g = []
    for atom in range(atoms):
        # a complex normal draw has variance 1/2 per part; (X + iY) / (2n)
        # has 1 / (4 n^2)
        x = torch.randn(n, n, generator=gen, dtype=dt, device=device)
        g.append(x.mul_(math.sqrt(2.0) / (2 * n)) if atom in keep else None)
        del x
    t = torch.randn(pool, n, n, generator=gen, dtype=dt.to_real(),
                    device=device).mul_(0.01).to(dt)
    t.diagonal(dim1=-2, dim2=-1).add_(1.0)
    return {"g": g, "t": t}


def schedule(cfg: dict, step: int) -> tuple:
    """(atom, energy point, t-matrix index, z) of step ``step``."""
    atoms = cfg["atoms_per_node"]
    atom = step % atoms
    energy = (step // atoms) % cfg["energies"]
    return atom, energy, step % cfg["tpool"], complex(0.1 + 0.05 * energy,
                                                      0.02)


def reference(cfg: dict, traffic: dict, inputs: dict, step: int,
              dtype: torch.dtype = None) -> dict:
    """The step's tau, in ``dtype`` (the configuration's by default), with
    plain torch: the library's product, LU and solves.  TF32 is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = dtype or dtype_of(cfg)
    atom, _, ti, z = schedule(cfg, step)
    t = inputs["t"][ti].to(dt)
    tg = torch.matmul(t, inputs["g"][atom].to(dt))
    m = torch.eye(cfg["n"], dtype=dt, device=t.device) - z * tg
    del tg
    lu, piv = torch.linalg.lu_factor(m)
    del m
    tau = torch.linalg.lu_solve(lu, piv, t[:, :cfg["nrhs"]])
    return {"tau": tau}


def compare(got: dict, want: dict) -> dict:
    """The numbers compared: tau's largest error over its largest
    entry."""
    ref = want["tau"]
    err = (got["tau"].to(ref.dtype) - ref).abs().max()
    return {"tau_err": float(err / ref.abs().max())}
