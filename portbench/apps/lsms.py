"""LSMS's KKR solve through ``repro_torch``, as MuST calls it.

Under one session (``policy``, ``lapack``, ``kernel_path`` ... from the
configuration) each step runs ``torch.matmul(t, G)``, the intercepted
zgemm with G host-born, then ``torch.linalg.lu_factor`` and ``lu_solve``,
the solver tier, and reads the energy on the host.  The arithmetic and
the inputs are those of :mod:`portbench.reference.lsms`.
"""
from __future__ import annotations

import torch

import repro_torch
from repro_torch.core import host_array

from portbench import counts
from portbench.reference import lsms as ref


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """``x`` in page-locked host memory, copied there once (``host_array``
    keeps a tensor that is pinned already); a CPU tensor as it is."""
    if x.device.type != "cuda":
        return x
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)


class App:
    """One process's LSMS: set up once, then one KKR solve per step."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 probe, session: dict):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.probe = torch.device(device), probe
        self.session_kw = session
        self.n, self.nrhs = cfg["n"], cfg["nrhs"]
        self.dtype = ref.dtype_of(cfg)
        self.warmup = cfg["warmup_steps"]
        self.index = 0
        self.session = None

    def setup(self) -> None:
        """Open the session, make the inputs (G on the host, as Fortran
        first-touches it; the t-matrices where the session computes), and
        warm up: each atom's zgemm, so each G has moved once, then
        ``warmup_steps`` whole steps, so every panel shape of the LU is
        captured."""
        self.session = repro_torch.session(
            repro_torch.OffloadConfig(**self.session_kw), device=self.device)
        inputs = ref.make_inputs(self.cfg, self.traffic, self.seed,
                                 self.device)
        drawn = inputs.pop("g")
        self.g = []
        for atom in range(len(drawn)):        # each draw freed once copied
            self.g.append(host_array(_pinned(drawn[atom])))
            drawn[atom] = None
        self.t = inputs.pop("t")
        self.eye = torch.eye(self.n, dtype=self.dtype, device=self.device)
        for g in self.g:
            torch.matmul(self.t[0], g)              # G's first device use
        for _ in range(self.warmup):
            self.step()

    def step(self) -> tuple:
        """One KKR solve: (step number, energy, outputs to check)."""
        g = self.index
        atom, _, ti, z = ref.schedule(self.cfg, g)
        t = self.t[ti]
        n, dt = self.n, self.cfg["dtype"]
        with self.probe.blas(*counts.gemm(n, n, n, dt)):
            tg = torch.matmul(t, self.g[atom])      # intercepted zgemm
        # a Mem-Copy session returns the product on the host
        m = self.eye - z * tg.to(self.device)
        del tg
        with self.probe.span("lu"):
            lu, piv = torch.linalg.lu_factor(m)     # the solver tier
            tau = torch.linalg.lu_solve(lu, piv, t[:, :self.nrhs])
        energy = float(torch.diagonal(tau).sum().real) / n
        self.index += 1
        return g, energy, {"tau": tau}

    def flops_per_step(self) -> float:
        n, dt = self.n, self.cfg["dtype"]
        return (counts.gemm(n, n, n, dt)[0] + counts.getrf(n, dt)
                + counts.getrs(n, self.nrhs, dt))

    def stats(self):
        return self.session.stats

    def close(self) -> None:
        """Close the session and drop every input and placement."""
        if self.session is not None:
            self.session.close()
        self.session = self.g = self.t = self.eye = None
