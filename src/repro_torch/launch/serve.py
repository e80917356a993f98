"""Serving entry point: batched decoding with offload-policy cache placement.

The counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b \\
        --reduced --batch 2 --prompt-len 32 --gen 16 --policy dfu \\
        --device cpu

Without ``--device`` it serves on the card (``cuda:0``) and raises when
there is none.  ``--offload-config tuned.json`` serves inside a port
session running those settings (``OffloadConfig.load``); the session
report prints at exit.  ``--streams N > 1`` (N concurrent streams over a
shared device pool) needs the reference's ``SharedDevicePool``, which is
not ported yet (ROADMAP Queue 1 item 7): it raises.  Weights come from a
seeded ``torch.Generator`` (seed 0), the prompt from seed 1; both differ
from the reference's JAX draws.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--policy", default="dfu",
                    choices=["dfu", "memcopy", "pinned"])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--offload-config", default="",
                    help="OffloadConfig JSON: serve inside a session "
                         "running these settings")
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent request streams (not ported yet)")
    ap.add_argument("--pool-mb", type=int, default=256,
                    help="shared pool capacity for --streams > 1")
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    if args.streams > 1:
        raise NotImplementedError(
            "--streams > 1 needs the shared device pool "
            "(SharedDevicePool), not ported yet: ROADMAP Queue 1 item 7")

    import torch

    from repro_torch.configs.base import torch_dtype
    from repro_torch.core import memspace
    from repro_torch.models import get_config
    from repro_torch.models.registry import Model
    from repro_torch.train import Server, ServeConfig

    device = memspace.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model.from_config(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    scfg = ServeConfig(max_len=args.prompt_len + args.gen,
                       temperature=args.temperature,
                       offload_policy=args.policy,
                       cache_dtype=torch_dtype(cfg.dtype))
    srv = Server(model, params, scfg, device=device)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1))
    session = None
    if args.offload_config:
        from repro_torch.core.config import OffloadConfig
        from repro_torch.core.session import Session
        session = Session(OffloadConfig.load(args.offload_config),
                          device=device).open()
    try:
        out = srv.generate(prompt, args.gen)
    finally:
        if session is not None:
            print(session.report())
            session.close()
    s = srv.stats
    tps = s.tokens / max(1e-9, s.decode_s)
    print(f"arch={cfg.name} policy={args.policy} device={device}")
    print(f"generated {tuple(out.shape)} prefill={s.prefill_s:.3f}s "
          f"decode={s.decode_s:.3f}s ({tps:.1f} tok/s)")
    print(f"state moved: h->d {s.bytes_host_to_dev/1e6:.2f} MB, "
          f"d->h {s.bytes_dev_to_host/1e6:.2f} MB, "
          f"migrations={s.migrations}, cache reuses={s.cache_reuses}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
