"""Optimizer and LR schedules (functional, over param pytrees)."""
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_init, adamw_update, global_norm,
    optimizer_abstract_state, optimizer_state_axes,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "optimizer_abstract_state", "optimizer_state_axes",
           "cosine_schedule", "linear_warmup_cosine"]
