"""PARSEC's block products through ``repro_torch``, as its ScaLAPACK layer
calls BLAS.

Under one session each step runs one block's ``products_per_block``
products ``torch.matmul(Hpsi_b.mT, Psi)`` (intercepted dgemms, 32 x 2400 x
93536 at the paper's shape) against the unchanged panel, then reads a
checksum on the host.  Psi and the blocks are host-born.  The arithmetic
and the inputs are those of :mod:`portbench.reference.parsec`.
"""
from __future__ import annotations

import torch

import repro_torch
from repro_torch.core import host_array

from portbench import counts
from portbench.reference import parsec as ref


class App:
    """One process's PARSEC: set up once, then one block's products per
    step."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 probe, session: dict):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.probe = torch.device(device), probe
        self.session_kw = session
        self.warmup = cfg["warmup_steps"]
        self.index = 0
        self.session = None

    def setup(self) -> None:
        """Open the session, make Psi and the blocks on the host, and
        warm up."""
        self.session = repro_torch.session(
            repro_torch.OffloadConfig(**self.session_kw), device=self.device)
        inputs = ref.make_inputs(self.cfg, self.traffic, self.seed,
                                 self.device)
        self.psi = host_array(inputs.pop("psi"))
        self.hpsi = [host_array(h) for h in inputs.pop("hpsi")]
        del inputs
        for _ in range(self.warmup):
            self.step()

    def step(self) -> tuple:
        """One block's products: (step number, checksum, outputs to
        check)."""
        g = self.index
        h = self.hpsi[ref.block_of(self.cfg, g)]
        cost = counts.gemm(self.cfg["nblock"], self.cfg["nstates"],
                           self.cfg["ngrid"], self.cfg["dtype"])
        outs = []
        for _ in range(self.cfg["products_per_block"]):
            with self.probe.blas(*cost):
                outs.append(torch.matmul(h.mT, self.psi))  # dgemm
        s = torch.stack(outs)
        checksum = float(s.sum())
        self.index += 1
        return g, checksum, {"s": s}

    def flops_per_step(self) -> float:
        return self.cfg["products_per_block"] * counts.gemm(
            self.cfg["nblock"], self.cfg["nstates"], self.cfg["ngrid"],
            self.cfg["dtype"])[0]

    def stats(self):
        return self.session.stats

    def close(self) -> None:
        """Close the session and drop every input and placement."""
        if self.session is not None:
            self.session.close()
        self.session = self.psi = self.hpsi = None
