"""MuST / LSMS proxy (paper §4.2), on PyTorch.

The port's counterpart of ``repro/apps/lsms.py:27-137``.  LSMS solves the
Kohn-Sham equation via multiple-scattering Green's functions: per atom,
per energy-grid point, per SCF iteration, build the KKR matrix
``M = I - z t G`` over the local interaction zone and solve
``M tau = t`` — in production via zgetrf/zgetrs, whose panel updates are
the zgemm/ztrsm stream that is 80 %+ of runtime.

``run_mini`` executes the real numerics through the public PyTorch
symbols: under an open session the ``t @ G`` product is an intercepted
zgemm, G is host-first-touched and migrates once per atom under Device
First-Use, and the LU factorization and solve go through
``torch.linalg.lu_factor``/``lu_solve``.  Under ``OffloadConfig.lapack``
those are the patched solver tier (:mod:`repro_torch.solvers`): a getrf
and a getrs span per solve, whose panel updates are the zgemm/ztrsm
stream; without it they are PyTorch's own, as the reference leaves them
to XLA.  ``production_trace`` emits the 50-node-scale
call structure of Table 3 — one resident KKR buffer per atom reused
across all (energy x SCF) solves, the reuse pattern (~780x) Device
First-Use exploits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import memspace, runtime
from repro_torch.core.policy import host_array
from repro_torch.core.trace import Trace
from repro_torch.kernels import ref

# Production workload (paper): 5600 atoms over 50 nodes, 32 energies,
# 3 SCF steps. KKR matrix n ~ LIZ x (lmax+1)^2 x spin; n=6912 calibrated
# so the CPU-policy replay reproduces Table 3's 2080 s of zgemm+ztrsm on
# the Grace-Grace node. nb=256 is the production LU blocking (also sets
# Mem-Copy's per-call staging volume, paper: 291.7 s).
PROD = dict(atoms_per_node=112, energies=32, scf=3, n=6912, nb=256,
            nrhs=32)


@dataclasses.dataclass
class LsmsResult:
    energy: float
    n_solves: int
    trace: Trace


def _getrf_stream(t: Trace, tau: int, tmat: int, n: int, nb: int,
                  nrhs: int) -> None:
    """BLAS stream of one blocked zgetrf + zgetrs on buffer ``tau``.

    Fortran LU factors in place: every panel/trailing-matrix call reads
    and writes regions of the SAME allocation — so all calls reference
    one buffer id, exactly what the DBI interceptor observes.
    """
    for j0 in range(0, n - nb, nb):
        rem = n - j0 - nb
        # panel factor stays on the CPU (getf2 is not level-3 BLAS)
        t.panel("z", n - j0, nb, tau)
        # U12 = L11^{-1} A12
        t.trsm("z", nb, rem, tau, tau)
        # A22 -= L21 @ U12   (the hot zgemm)
        t.gemm("z", rem, rem, nb, tau, tau, tau)
    # zgetrs: forward + back substitution against the t-matrix RHS
    t.trsm("z", n, nrhs, tau, tmat)
    t.trsm("z", n, nrhs, tau, tmat)


def production_trace(atoms_per_node: int = PROD["atoms_per_node"],
                     energies: int = PROD["energies"],
                     scf: int = PROD["scf"], n: int = PROD["n"],
                     nb: int = PROD["nb"],
                     nrhs: int = PROD["nrhs"]) -> Trace:
    """One Grace-Hopper node's BLAS stream for the Table 3 workload."""
    t = Trace()
    el = 16  # complex128
    taus = [t.new_buffer(n * n * el, f"tau_atom{a}")
            for a in range(atoms_per_node)]
    tmats = [t.new_buffer(n * nrhs * el, f"t_atom{a}")
             for a in range(atoms_per_node)]
    for _ in range(scf):
        for _e in range(energies):
            for a in range(atoms_per_node):
                _getrf_stream(t, taus[a], tmats[a], n, nb, nrhs)
    return t


def run_mini(atoms: int = 4, energies: int = 4, scf: int = 2,
             n: int = 192, nb: int = 64, seed: int = 0,
             dtype=torch.complex128, device=None) -> Dict[str, float]:
    """Tiny LSMS: real KKR-style solves with verification.

    Returns the total energy proxy, the largest residual max|M tau - t|,
    and the number of solves, so callers can assert the physics loop is
    numerically sound under every offload policy.  ``device=None`` runs
    on ``cuda:0`` and raises without CUDA; ``device="cpu"`` runs on the
    CPU.  ``nb`` is kept for the reference's signature, which ignores it
    too: the solver tier's block size is the session's ``lapack_nb``.
    The inputs are drawn with numpy from ``seed`` in the reference's
    order, so both packages see the same matrices.
    """
    del nb
    dev = memspace.resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    # structure "constants" G per atom: fixed across SCF; host-first-
    # touched like Fortran allocations, reused across all solves
    gmats = [host_array(
        (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
        / (2 * n), dtype) for _ in range(atoms)]
    if runtime.active() is None:
        # no session intercepts the product: compute where tm lives
        gmats = [g.to(dev) for g in gmats]
    eye = torch.eye(n, dtype=dtype, device=dev)
    energy = 0.0
    max_resid = 0.0
    n_solves = 0
    tmat_scale = 1.0
    for it in range(scf):
        for e in range(energies):
            z = 0.1 + 0.05 * e + 0.02j
            for a in range(atoms):
                # the t-matrix is made where the session computes
                tm = torch.as_tensor(
                    tmat_scale * (np.eye(n)
                                  + 0.01 * rng.standard_normal((n, n))),
                    dtype=dtype, device=dev)
                tg = torch.matmul(tm, gmats[a])    # intercepted zgemm
                # a Mem-Copy session returns the product on the host
                # tier; the card has no coherent link to read it there,
                # so the loop brings it back (no-op elsewhere)
                m = eye - z * tg.to(dev)
                # the public symbols: the patched solver tier under a
                # lapack session, PyTorch's own without one
                lu, piv = torch.linalg.lu_factor(m)
                tau = torch.linalg.lu_solve(lu, piv, tm)
                # verification with the plain product: not BLAS stream
                resid = float((ref.torch_matmul(m, tau) - tm).abs().max())
                max_resid = max(max_resid, resid)
                energy += float(torch.trace(tau).real) / n
                n_solves += 1
        tmat_scale *= 0.98  # SCF mixing proxy
    return {"energy": energy, "max_resid": max_resid,
            "n_solves": n_solves}
