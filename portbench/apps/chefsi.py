"""CheFSI's subspace step through ``repro_torch``, as a Fortran PARSEC
calls BLAS and LAPACK.

Under one session each step takes one spin channel's Psi and H Psi
(host-born, unchanged) and runs Cholesky QR and Rayleigh-Ritz on them:
``blas.syrk`` for the Gram matrix, the library's Cholesky, two
``blas.trsm`` with side R, ``torch.matmul`` (intercepted dgemms) for Hs
and the rotation, the library's eigh between them; then it reads the sum
of the Ritz values on the host.  The arithmetic and the inputs are those
of :mod:`portbench.reference.chefsi`.
"""
from __future__ import annotations

import torch

import repro_torch
from repro_torch.core import blas, host_array

from portbench import counts, counts_chefsi
from portbench.apps.lsms import _pinned
from portbench.reference import chefsi as ref


class App:
    """One process's CheFSI: set up once, then one channel's
    orthonormalization and Rayleigh-Ritz step per step."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 probe, session: dict):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.probe = torch.device(device), probe
        self.session_kw = session
        self.warmup = cfg["warmup_steps"]
        self.index = 0
        self.session = None

    def setup(self) -> None:
        """Open the session, make each channel's Psi and H Psi on the
        host, and warm up: a step per channel moves each of them once."""
        self.session = repro_torch.session(
            repro_torch.OffloadConfig(**self.session_kw), device=self.device)
        inputs = ref.make_inputs(self.cfg, self.traffic, self.seed,
                                 self.device)
        self.psi, self.hpsi = [], []
        for name, kept in (("psi", self.psi), ("hpsi", self.hpsi)):
            drawn = inputs.pop(name)
            for ch in range(len(drawn)):      # each draw freed once copied
                kept.append(host_array(_pinned(drawn[ch])))
                drawn[ch] = None
        del inputs
        for _ in range(self.warmup):
            self.step()

    def step(self) -> tuple:
        """One channel's subspace step: (step number, sum of the Ritz
        values, outputs to check)."""
        g = self.index
        ch = ref.channel_of(self.cfg, g)
        psi, hpsi = self.psi[ch], self.hpsi[ch]
        k, n, dt = self.cfg["ngrid"], self.cfg["nstates"], self.cfg["dtype"]
        probe = self.probe
        with probe.span("orth"):
            with probe.blas(*counts.syrk(n, k, dt)):
                s = blas.syrk(psi, uplo="U", trans="T")     # dsyrk
            r = torch.linalg.cholesky(s, upper=True)       # reads U
            del s
            with probe.span("trsm"):
                with probe.blas(*counts_chefsi.trsm(k, n, dt)):
                    psi_o = blas.trsm(r, psi, side="R", uplo="U")
                with probe.blas(*counts_chefsi.trsm(k, n, dt)):
                    hpsi_o = blas.trsm(r, hpsi, side="R", uplo="U")
        with probe.span("rr"):
            with probe.blas(*counts.gemm(n, n, k, dt)):
                hs = torch.matmul(psi_o.mT, hpsi_o)         # dgemm
            del hpsi_o
            w, q = torch.linalg.eigh(hs)                    # reads L
            del hs
            with probe.blas(*counts.gemm(k, n, n, dt)):
                psi_new = torch.matmul(psi_o, q)            # dgemm
        del psi_o, q
        value = float(w.sum())
        self.index += 1
        return g, value, {"w": w, "r": r, "psi": psi_new}

    def flops_per_step(self) -> float:
        return counts_chefsi.step(self.cfg["ngrid"], self.cfg["nstates"],
                           self.cfg["dtype"])

    def stats(self):
        return self.session.stats

    def close(self) -> None:
        """Close the session and drop every input and placement."""
        if self.session is not None:
            self.session.close()
        self.session = self.psi = self.hpsi = None
