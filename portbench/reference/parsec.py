"""Plain reference of the PARSEC step, and the inputs both sides take.

PARSEC's subspace work (arXiv 2501.00279 section 4.3, Tables 5-6) reaches
BLAS as tall-skinny products of a block of ``nblock`` states against the
wavefunction panel Psi (ngrid x nstates).  The call stream follows the
repository's calibration of Table 5 (``repro_torch.apps.dft.PROD`` and
``production_trace``): in each filter sweep every block b of the
nstates / nblock blocks takes ``products_per_block`` products (the
orthogonalization sub-iterations) against the unchanged panel:

    S_b = Hpsi_b^T @ Psi     Hpsi_b ngrid x nblock, S_b nblock x nstates

One step is one block's products, blocks in turn: step g takes block
g % (nstates / nblock).  Every product of a step has the same operands,
so each one's answer is S_b.
"""
from __future__ import annotations

import torch

LOWER = {torch.float64: torch.float32, torch.complex128: torch.complex64}


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def blocks(cfg: dict) -> int:
    return cfg["nstates"] // cfg["nblock"]


def block_of(cfg: dict, step: int) -> int:
    """The block whose products step ``step`` runs."""
    return step % blocks(cfg)


def make_inputs(cfg: dict, traffic: dict, seed: int, device,
                steps=None) -> dict:
    """Psi and the Hpsi blocks, standard normal, on ``device`` from one
    generator seeded with ``seed`` (all of them, whatever ``steps``)."""
    ngrid, nblock, dt = cfg["ngrid"], cfg["nblock"], dtype_of(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"psi": torch.randn(ngrid, cfg["nstates"], generator=gen,
                               dtype=dt, device=device),
            "hpsi": torch.randn(blocks(cfg), ngrid, nblock, generator=gen,
                                dtype=dt, device=device)}


def reference(cfg: dict, traffic: dict, inputs: dict, step: int,
              dtype: torch.dtype = None) -> dict:
    """The step's S_b, in ``dtype`` (the configuration's by default),
    with plain torch.matmul; TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = dtype or dtype_of(cfg)
    h = inputs["hpsi"][block_of(cfg, step)].to(dt)
    return {"s": torch.matmul(h.mT, inputs["psi"].to(dt))}


def compare(got: dict, want: dict) -> dict:
    """The number compared: the largest error of any of the step's
    products (``got["s"]`` stacks them, or is one) over S_b's largest
    entry."""
    ref = want["s"]
    err = (got["s"].to(ref.dtype) - ref).abs().max()
    return {"s_err": float(err / ref.abs().max())}
