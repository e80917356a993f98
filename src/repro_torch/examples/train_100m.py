"""End-to-end driver: train a ~100M-parameter LM.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300

The twin of the JAX package's ``examples/train_100m.py``, with the full
substrate in play: the deterministic data pipeline, AdamW with a cosine
schedule, two microbatches, remat of everything but the projections'
outputs (``dots``), async checkpoints every ``--ckpt-every`` steps and
the straggler watchdog.  The model is float32, so every projection runs
``csrc/gemm.cu``'s float32 FMA path (forward, dA and dB) and every
attention forward ``csrc/flash_attention.cu``'s FMA path.

Without ``--device`` it trains on the card (``cuda:0``) and raises when
there is none; ``--device cpu`` trains on the CPU (``--steps 3 --batch 4
--seq 32`` there).  Checkpoints go to ``build/train_100m_ckpt`` at the
root of the checkout unless ``--ckpt-dir`` says otherwise (the
reference writes under ``/tmp``); a run resumes from the latest one
found there, as ``Trainer.fit`` does.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.configs.base import ModelConfig
from repro_torch.core import memspace
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models.registry import Model
from repro_torch.train import Trainer, TrainConfig

CONFIG_100M = ModelConfig(
    name="repro-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32000,
    tie_embeddings=True, dtype="float32",
)

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_100m_ckpt"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    dev = memspace.resolve_device(args.device)

    total, active = CONFIG_100M.param_count()
    print(f"model: {CONFIG_100M.name}  params={total / 1e6:.1f}M")
    model = Model.from_config(CONFIG_100M)
    pipe = TokenPipeline(DataConfig(vocab=CONFIG_100M.vocab,
                                    seq_len=args.seq,
                                    global_batch=args.batch))
    tcfg = TrainConfig(steps=args.steps, n_micro=2, remat="dots",
                       ckpt_every=args.ckpt_every, log_every=10)
    trainer = Trainer(model, pipe, tcfg, ckpt_dir=args.ckpt_dir, device=dev)
    hist = trainer.fit()
    if hist:
        print(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"over {len(hist)} steps")
    else:
        print(f"resumed at step {trainer.step} from {args.ckpt_dir}: "
              f"no step left to run")
    return {"params": total, "history": hist, "trainer": trainer}


if __name__ == "__main__":
    main()
