"""PARSEC proxy: tall-skinny dgemm offload (paper Table 5).

    PYTHONPATH=src python -m repro_torch.examples.parsec_dft [--device cpu]

The twin of the JAX package's ``examples/parsec_dft.py``.  Runs a real
Chebyshev-filtered subspace iteration (``repro_torch.apps.dft.run_mini``,
Ritz values verified against dense ``numpy.linalg.eigvalsh``) under the
interception layer with Device First-Use, then replays the production
tall-skinny dgemm stream through the port's memtier model, on the
paper's GH200 constants (the reference's table) and on the H100 model:
Mem-Copy drowns in transfers, the access counter strands the 1.8 GB
panel on the host, Device First-Use moves it once.

Without ``--device`` it runs on ``cuda:0`` and raises when there is
none; ``--device cpu`` runs the simulated tiers.  ``--ngrid``,
``--nstates``, ``--scf`` and ``--cheb-order`` size the subspace iteration
(the reference's sizes by default); a larger problem needs more filter
passes (``--scf``) to meet the same bound.  ``--part live`` runs the
iteration alone, ``--part replay`` the replay alone.
"""
from __future__ import annotations

import argparse

from repro_torch.apps import dft
from repro_torch.core import intercept, memspace
from repro_torch.core.config import OffloadConfig
from repro_torch.examples import must_lsms

THRESHOLD = 200.0
#: the converged lower half of the Ritz values against dense eigvalsh
RITZ_TOL = 1e-6


def run_live(ngrid: int, nstates: int, scf: int, cheb_order: int,
             device=None, sync: bool = False) -> dict:
    """``dft.run_mini`` inside a legacy DFU session at threshold 200;
    the result, the session's statistics and its trace."""
    dev = memspace.resolve_device(device)
    config = OffloadConfig.legacy(policy="dfu", threshold=THRESHOLD)
    if sync:
        config = config.replace(sync=True)
    runtime = intercept.install(config=config, device=dev)
    try:
        out = dft.run_mini(ngrid=ngrid, nstates=nstates, scf=scf,
                           cheb_order=cheb_order, device=dev)
    finally:
        stats = intercept.uninstall()
    print(f"ritz_min={out['ritz_min']:.6f} exact={out['exact_min']:.6f} "
          f"max_err(low half)={out['max_err_low_half']:.2e}")
    assert out["max_err_low_half"] < RITZ_TOL
    print(stats.report())
    return dict(out, stats=stats, trace=runtime.trace)


def replay(trace, specs=must_lsms.SPEC_NAMES) -> dict:
    """``trace`` under every policy on each named spec, with its table and
    the DFU-versus-CPU ratio; the reports per spec."""
    return must_lsms.replay(trace, specs, label="dgemm_s",
                            paper="Table 5, GH200: ~1.9x total, ~10x on "
                                  "dgemm")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ngrid", type=int, default=1024)
    ap.add_argument("--nstates", type=int, default=32)
    ap.add_argument("--scf", type=int, default=8)
    ap.add_argument("--cheb-order", type=int, default=10)
    ap.add_argument("--sync", action="store_true",
                    help="synchronize every intercepted call")
    ap.add_argument("--part", default="all",
                    choices=["all", "live", "replay"])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    result: dict = {}
    if args.part in ("all", "live"):
        print("== runnable mini-PARSEC (subspace iteration) ==")
        result["live"] = run_live(args.ngrid, args.nstates, args.scf,
                                  args.cheb_order, device=args.device,
                                  sync=args.sync)
    if args.part in ("all", "replay"):
        result["replay"] = replay(dft.production_trace())
    return result


if __name__ == "__main__":
    main()
