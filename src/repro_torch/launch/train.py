"""End-to-end training driver.

The counterpart of ``repro/launch/train.py``, with its flags plus
``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1_5_4b \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu

Without ``--device`` it trains on the card (``cuda:0``) and raises when
there is none.  An enc-dec model gets ones-valued stub ``frames``, a VLM
ones-valued ``patch_embeds``, as the reference's driver feeds them.
``--offload-config tuned.json`` trains inside a port session running
those settings; the session report prints at exit.

``--mesh single|multi --dry-compile`` runs the dry run of the sharded
training step instead (``launch/dryrun.py`` ``run_cell(arch,
"train_4k", ...)`` at the full config, ignoring ``--reduced``, as the
reference's ``:44-50``), over a fake process group of
``DRYRUN_DEVICES`` ranks (default 512); it needs no card.  Either flag
alone trains as without it, as in the reference.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    choices=[None, "single", "multi"])
    ap.add_argument("--dry-compile", action="store_true",
                    help="lower+compile the sharded step, do not run")
    ap.add_argument("--offload-config", default="",
                    help="OffloadConfig JSON: train inside a session "
                         "running these settings")
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    if args.mesh and args.dry_compile:
        os.environ.setdefault("DRYRUN_DEVICES", "512")
        from repro_torch.launch.dryrun import run_cell
        rec = run_cell(args.arch, "train_4k", args.mesh == "multi",
                       remat=args.remat, n_micro=args.n_micro,
                       grad_compress=args.grad_compress, out_dir=None)
        return 0 if rec["status"] == "ok" else 1

    import torch

    from repro_torch.configs.base import torch_dtype
    from repro_torch.core import memspace
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import get_config
    from repro_torch.models.registry import Model
    from repro_torch.train import Trainer, TrainConfig

    device = memspace.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model.from_config(cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    shapes = model.extra_inputs(args.batch, args.seq)
    extra_fn = None
    if shapes:
        def extra_fn(step):
            return {k: torch.ones(s, dtype=torch_dtype(cfg.dtype))
                    for k, s in shapes.items()}
    tcfg = TrainConfig(steps=args.steps, peak_lr=args.lr,
                       n_micro=args.n_micro, remat=args.remat,
                       grad_compress=args.grad_compress,
                       ckpt_every=args.ckpt_every,
                       moe_impl="dense" if args.reduced else "scatter")
    trainer = Trainer(model, pipe, tcfg, ckpt_dir=args.ckpt_dir,
                      extra_batch_fn=extra_fn, device=device)
    session = None
    if args.offload_config:
        from repro_torch.core.config import OffloadConfig
        from repro_torch.core.session import Session
        session = Session(OffloadConfig.load(args.offload_config),
                          device=device).open()
    try:
        hist = trainer.fit()
    finally:
        if session is not None:
            print(session.report())
            session.close()
    print(f"final loss {hist[-1]['loss']:.4f} after {trainer.step} steps; "
          f"straggler events: {trainer.straggler_events}; device {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
