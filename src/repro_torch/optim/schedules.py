"""Learning-rate schedules: callables of a 0-d step tensor.

Counterpart of ``repro.optim.schedules``, in float32 tensor arithmetic on
the step's device.
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)
    return f


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(peak_lr, max(total_steps - warmup_steps, 1),
                          final_frac)

    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(step - warmup_steps))
    return f
