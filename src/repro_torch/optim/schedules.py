"""LR schedules as pure functions of the step counter (an int tensor,
scalar or stacked), in fp32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step)


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1):
    frac = torch.clamp(_steps(step) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return final_frac + (1 - final_frac) * cos


def linear_warmup_cosine(step, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    step = _steps(step)
    warm = torch.clamp(step / max(warmup_steps, 1), 0.0, 1.0)
    decay_step = torch.clamp(step - warmup_steps, min=0)
    decay = cosine_schedule(decay_step, max(total_steps - warmup_steps, 1),
                            final_frac)
    return torch.where(step < warmup_steps, warm, decay)
