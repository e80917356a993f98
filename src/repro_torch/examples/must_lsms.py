"""MuST/LSMS proxy under every data-movement policy (paper Table 3).

    PYTHONPATH=src python -m repro_torch.examples.must_lsms \\
        [--atoms 4 --energies 4] [--device cpu]

The twin of the JAX package's ``examples/must_lsms.py``.  Runs real
multiple-scattering solves (the KKR loop of ``repro_torch.apps.lsms``,
its ``t @ G`` an intercepted zgemm) under the cpu, memcopy, counter and
dfu policies, each in a legacy ``install()``/``uninstall()`` session of
its own, and checks that the physics is identical; then replays the
production-scale trace through the port's memtier model, on the paper's
GH200 constants (the reference's table) and on the H100 model of the
card the port runs on (``memtier.spec.H100``).

On the card every policy computes on the card: the ``cpu`` policy's host
path streams its operands there (``core/runtime.py`` ``_harmonize``), so
its live row is no CPU baseline; the replay's ``cpu`` row models one.
Without ``--device`` it runs on ``cuda:0`` and raises when there is
none; ``--device cpu`` runs the simulated tiers.  ``--sync`` makes every
intercepted call synchronize, so the per-routine seconds are device
times.  ``--part live`` runs the policies alone, ``--part replay`` the
replay alone.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Sequence

import torch

from repro_torch.apps import lsms
from repro_torch.core import intercept, memspace
from repro_torch.core.config import OffloadConfig
from repro_torch.core.trace import Trace
from repro_torch.memtier import replay_trace
from repro_torch.memtier.spec import SPECS

POLICIES = ("cpu", "memcopy", "counter", "dfu")
SPEC_NAMES = ("gh200", "h100")
THRESHOLD = 100.0
#: energies across policies: the same float64 LU of the same matrices
ENERGY_TOL = 1e-8


def run_policies(atoms: int, energies: int, scf: int, n: int,
                 dtype=torch.complex128, device=None,
                 sync: bool = False) -> Dict[str, dict]:
    """``run_mini`` once per policy, each inside its own
    ``install()``/``uninstall()``; per policy the result, the zgemm
    counters (``RoutineStats`` as a dict, seconds included), and the
    session's trace."""
    dev = memspace.resolve_device(device)
    results = {}
    for policy in POLICIES:
        config = OffloadConfig.legacy(policy=policy, threshold=THRESHOLD)
        if sync:
            config = config.replace(sync=True)
        runtime = intercept.install(config=config, device=dev)
        try:
            out = lsms.run_mini(atoms=atoms, energies=energies, scf=scf,
                                n=n, dtype=dtype, device=dev)
        finally:
            stats = intercept.uninstall()
        g = stats.per_routine.get("zgemm")
        results[policy] = dict(out, zgemm=dataclasses.asdict(g) if g
                               else None, trace=runtime.trace)
        print(f"policy={policy:8s} energy={out['energy']:+.6f} "
              f"resid={out['max_resid']:.2e} solves={out['n_solves']} "
              f"zgemm calls={g.calls if g else 0}")
    e0 = results[POLICIES[0]]["energy"]
    for p, r in results.items():
        assert abs(r["energy"] - e0) < ENERGY_TOL, (p, r["energy"], e0)
    print("energies identical across policies: OK\n")
    return results


def print_table(reports: Dict, label: str = "blas_s") -> None:
    """The reference's replay table: total, BLAS, movement, reuse."""
    print(f"{'policy':10s}{'total_s':>10s}{label:>10s}"
          f"{'movement_s':>12s}{'reuse':>8s}")
    for p, r in reports.items():
        print(f"{p:10s}{r.total_s:10.1f}"
              f"{r.blas_device_s + r.blas_host_s:10.1f}"
              f"{r.movement_s:12.2f}{r.mean_reuse:8.1f}")


def replay(trace: Trace, specs: Sequence[str] = SPEC_NAMES,
           label: str = "blas_s",
           paper: str = "Table 3, GH200: ~2.8x on zgemm+ztrsm-dominated "
                        "runtime") -> Dict[str, dict]:
    """``trace`` under every policy on each named spec, each table
    printed (``label`` heads the BLAS column) with the DFU-versus-CPU
    ratio beside the paper's (``paper``); the reports per spec."""
    out = {}
    for name in specs:
        print(f"\n== production-scale trace replay ({name} constants) ==")
        reports = replay_trace(trace, spec=SPECS[name], policies=POLICIES)
        print_table(reports, label)
        speedup = reports["cpu"].total_s / reports["dfu"].total_s
        print(f"\nDFU speedup vs CPU on {name}: {speedup:.2f}x "
              f"(paper {paper})")
        out[name] = reports
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--atoms", type=int, default=3)
    ap.add_argument("--energies", type=int, default=3)
    ap.add_argument("--scf", type=int, default=2)
    ap.add_argument("--n", type=int, default=160)
    ap.add_argument("--dtype", default="complex128",
                    choices=["complex128", "complex64"])
    ap.add_argument("--sync", action="store_true",
                    help="synchronize every intercepted call")
    ap.add_argument("--part", default="all",
                    choices=["all", "live", "replay"])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    result: dict = {}
    if args.part in ("all", "live"):
        print("== runnable mini-LSMS through the interception layer ==")
        result["policies"] = run_policies(
            args.atoms, args.energies, args.scf, args.n,
            dtype=getattr(torch, args.dtype), device=args.device,
            sync=args.sync)
    if args.part in ("all", "replay"):
        result["replay"] = replay(lsms.production_trace())
    return result


if __name__ == "__main__":
    main()
