"""LR schedules, computed in float32 tensors as the reference computes them."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor·peak_lr``.

    ``step`` is an int or a 0-d tensor; the result is a float32 0-d tensor
    on its device.  Step 0 gives 0 when ``warmup`` > 0.
    """
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
