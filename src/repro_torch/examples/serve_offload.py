"""LM serving with Device-First-Use cache placement.

    PYTHONPATH=src python -m repro_torch.examples.serve_offload [--device cpu]

The twin of the JAX package's ``examples/serve_offload.py``: the paper's
policies applied to the decode cache of an LM.  DFU migrates the cache
once at prefill; Mem-Copy round-trips it per token; pinned is born on
the device.  Generations must be identical under every policy.

``--arch`` (default ``mamba2_1_3b``) picks the config, ``--reduced``
(on by default, ``--no-reduced`` for full width and depth) its small
same-family version, as the reference's driver serves.  Weights come
from a ``torch.Generator`` seeded 0 on the serving device, the 4 x 16
prompt from one seeded 1, so both differ from the reference's JAX draws;
:func:`run` takes any weights and prompt, such as the reference's
carried over by ``models/convert.py``.  Without ``--device`` it serves
on ``cuda:0`` and raises when there is none; ``--device cpu`` runs the
simulated tiers.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.core import memspace
from repro_torch.models import get_config
from repro_torch.models.registry import Model
from repro_torch.train import Server, ServeConfig

POLICIES = ("dfu", "memcopy", "pinned")
BATCH, PROMPT, GEN, MAX_LEN = 4, 16, 32, 96


def run(model: Model, params, prompt: torch.Tensor,
        device=None) -> Dict[str, tuple]:
    """Generate GEN tokens from ``prompt`` under each policy, a
    ``Server`` each over the same ``params`` with a float32 cache of
    MAX_LEN slots; per policy (tokens, ServeStats).  Asserts identical
    generations."""
    dev = memspace.resolve_device(device)
    outs = {}
    for policy in POLICIES:
        srv = Server(model, params,
                     ServeConfig(max_len=MAX_LEN, offload_policy=policy,
                                 cache_dtype=torch.float32), device=dev)
        tokens = srv.generate(prompt, GEN)
        s = srv.stats
        print(f"{policy:8s} decode={s.decode_s:6.2f}s "
              f"h->d={s.bytes_host_to_dev / 1e6:8.2f}MB "
              f"d->h={s.bytes_dev_to_host / 1e6:8.2f}MB "
              f"migrations={s.migrations} reuses={s.cache_reuses}")
        outs[policy] = (tokens, s)
    first = outs[POLICIES[0]][0]
    for policy in POLICIES[1:]:
        assert torch.equal(outs[policy][0], first), policy
    print("identical generations under all policies: OK")
    return outs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_1_3b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the config's small version (default on)")
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    dev = memspace.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model.from_config(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    return run(model, params, prompt, device=dev)


if __name__ == "__main__":
    main()
