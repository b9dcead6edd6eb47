"""Public DP ops: the row-norm pre-pass, backend dispatch, pytree ravel.

  dp_clip_noise       DP publication of the raw stacked rows (P, N) under a
                      uint32 round seed: per-row L2 clip + Gaussian noise
                      from the counter-based PRG.
  dp_clip_noise_tree  the stacked-pytree front end the overlay calls.

Same ``impl`` spellings, seed contract and `force_impl` override as the
secure-agg ops.
"""
from __future__ import annotations

import torch

from repro_torch.core.secure_agg import ravel_stacked
from repro_torch.kernels.dp import kernel as _k
from repro_torch.kernels.dp import ref as _ref
from repro_torch.kernels.secure_agg.ops import (  # noqa: F401 (force_impl)
    force_impl, normalize_seed, resolve_impl,
)


def dp_clip_noise(updates: torch.Tensor, seed, clip_norm: float,
                  noise_multiplier: float, *, mask=None,
                  impl: str = "auto") -> torch.Tensor:
    """(P, N) -> (P, N): surviving row p = min(1, C/||u_p||) * u_p +
    sigma*C * z_p; dropped rows pass through.  The row norms are computed
    once here and handed to whichever version runs."""
    impl = resolve_impl(impl)
    seed = normalize_seed(seed)
    norms = _ref._row_norms(updates)
    if impl == "fused":
        return _k.clip_noise_flat(updates, norms, seed, clip_norm,
                                  noise_multiplier, mask)
    return _ref.clip_noise_reference(updates, seed, clip_norm,
                                     noise_multiplier, mask, norms)


def dp_clip_noise_tree(stacked, seed, clip_norm: float,
                       noise_multiplier: float, *, mask=None,
                       impl: str = "auto"):
    """Stacked (P, ...) pytree in, DP-published stacked tree out: one
    (P, N) ravel, no per-institution loop."""
    rows, unravel = ravel_stacked(stacked)
    return unravel(dp_clip_noise(rows, seed, clip_norm, noise_multiplier,
                                 mask=mask, impl=impl))
