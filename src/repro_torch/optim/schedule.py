"""LR schedules (counterpart of ``repro/optim/schedule.py``): pure
functions of the step index, float32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr=3e-4, warmup=100, total=10_000,
                  min_ratio=0.1, device=None):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total``; ``step`` an int or an
    integer tensor -> a float32 tensor (on ``device``, or the step's)."""
    t = torch.as_tensor(step, device=device).to(torch.float32)
    warm = peak_lr * (t + 1.0) / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
