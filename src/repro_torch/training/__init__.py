"""Training: loss, grads, microbatching, remat and AdamW, as the
centralized step and the overlay's institution-local step."""
from repro_torch.training.train import (
    TrainConfig, TrainState, make_local_step, make_loss_fn, make_train_step,
    resolve_impl,
)

__all__ = ["TrainConfig", "TrainState", "make_local_step", "make_loss_fn",
           "make_train_step", "resolve_impl"]
