"""Optimizer and LR schedules (functional, over param pytrees)."""
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_init, adamw_update, global_norm,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup_cosine"]
