"""LR schedules."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps,
                    min_ratio=0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``min_ratio * peak_lr`` at ``total_steps`` (held after).
    ``step`` is an int or an integer tensor; the result is an f32 scalar
    on its device, computed op by op in f32 as the reference does
    (Python constants rounded to f32 at each op)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    step = torch.as_tensor(step, device=dev).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
