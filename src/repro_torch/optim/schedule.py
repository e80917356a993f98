"""Learning-rate schedules (``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``floor_frac * peak_lr``; a
    float32 0-d tensor, computed in float32 as the reference computes
    it."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(1.0, warmup)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    floor = floor_frac * peak_lr
    cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
