"""Quickstart: automatic BLAS offload on unmodified PyTorch code.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The twin of the JAX package's ``examples/quickstart.py``.  Inside
``repro_torch.session(config)``, plain ``torch.matmul`` / ``@`` /
``torch.einsum`` / ``torch.mm`` / ``torch.mv`` calls are intercepted,
placed per the Device First-Use policy, and counted.  The config is a
typed ``OffloadConfig``; ``SCILIB_*`` variables layer over the script's
defaults through ``OffloadConfig.legacy``, as in the reference.

Without ``--device`` it runs on the card (``cuda:0``) and raises when
there is none; ``--device cpu`` runs the simulated tiers.  The gemv's
vector is born on the session's device, where the reference slices a
host column (``b[:, 0]`` of a host array fails in JAX 0.9's
``dot_general``).  The check against plain execution keeps the
reference's tolerances; for the two chains of products (``c`` and ``d``)
the absolute part is scaled by the largest entry, since entries of
~1e9 cancel to near zero and any other summation order (the card's
kernel against the library) moves them by ~1e-6 of the largest.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

import repro_torch
from repro_torch import OffloadConfig
from repro_torch.core import memspace
from repro_torch.core.policy import host_array

SIZE = 768
#: the reference's tolerances, (rtol, atol) per checked result
TOLS = {"c": (2e-4, 2e-4), "d": (2e-3, 2e-3), "y": (2e-3, 2e-3)}
#: results whose atol is relative to their largest entry (chains)
CHAINS = ("c", "d")


def application_code(a, b, x):
    """Completely ordinary PyTorch code: no offload imports, no changes."""
    c = torch.matmul(a, b)                 # offloaded (large)
    for _ in range(5):
        c = a @ c                          # reuses device-resident a, c
    d = torch.einsum("ij,kj->ik", c, b)    # transposed gemm, intercepted
    small = torch.mm(a[:64, :64], b[:64, :64])   # stays on host (N_avg)
    y = torch.mv(a, x)                     # gemv-shaped: counted, host
    return c, d, small, y


def counters(stats) -> dict:
    """Every per-routine counter of a session, wall time left out."""
    return {name: {k: v for k, v in dataclasses.asdict(r).items()
                   if k != "seconds"}
            for name, r in stats.per_routine.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    dev = memspace.resolve_device(args.device)
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((SIZE, SIZE)).astype("float32")
    b_np = rng.standard_normal((SIZE, SIZE)).astype("float32")

    # the script's defaults, with env knobs (SCILIB_THRESHOLD=10, ...)
    # layering over them, as the legacy install(policy="dfu",
    # threshold=500) this replaces
    config = OffloadConfig.legacy(policy="dfu", threshold=500.0)
    with repro_torch.session(config, device=dev) as s:
        # host_array = the malloc() analogue: inputs are CPU-first-touched
        a, b = host_array(a_np), host_array(b_np)
        x = torch.as_tensor(b_np[:, 0].copy(), device=dev)
        c, d, small, y = application_code(a, b, x)
        s.sync()
        report = s.report()
        print(report)
        reuse = s.runtime.mean_buffer_reuse()
        tier = memspace.tier_of(c)
        space = memspace.active()
        got = counters(s.stats)
    print(f"\nresult tier: {tier} (memory kind {space.kind_of(tier)}, "
          f"device {space.device}{', simulated' if space.simulated else ''})")
    print(f"mean buffer reuse: {reuse:.1f}")
    # verify against plain execution (the session is closed: these run
    # through the original, un-intercepted symbols, on the same device)
    plain = application_code(a.to(dev), b.to(dev), x)
    for name, have, want in zip(("c", "d", "small", "y"),
                                (c, d, small, y), plain):
        if name not in TOLS:
            continue
        want = want.cpu().numpy()
        rtol, atol = TOLS[name]
        if name in CHAINS:
            atol *= float(np.abs(want).max())
        np.testing.assert_allclose(have.cpu().numpy(), want, rtol=rtol,
                                   atol=atol, err_msg=name)
    print("results identical with offload enabled: OK")
    return {"counters": got, "reuse": reuse, "tier": tier,
            "report": report}


if __name__ == "__main__":
    main()
