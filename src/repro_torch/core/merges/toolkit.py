"""Shared masked-reduce primitives for merge strategies: the consensus
gate, mask broadcasting, the survivor count, mean and abs-max, the
rolling update and the ring re-stitched around dead institutions.

Every helper excludes dead rows with ``where()`` rather than
multiplication, so a dropped institution holding inf/NaN cannot poison
the survivors' reduction (``inf * 0`` is NaN).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.pytree import tree_map

Pytree = Any


def gate(merged: Pytree, original: Pytree, commit) -> Pytree:
    """Consensus gate: the merged tree when `commit`, else the original
    (a rejected round leaves every institution bit-identical).  `commit`
    is a host bool: the port precomputes every round's consensus."""
    if bool(commit):
        return tree_map(lambda m, o: m.to(o.dtype), merged, original)
    return original


def mask_nd(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(P,) mask reshaped to broadcast against a (P, ...) leaf."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


def survivor_count(mask: torch.Tensor) -> torch.Tensor:
    """f32 survivor count, clamped to >= 1 so an all-dead round cannot
    divide by zero."""
    return torch.clamp(mask.to(torch.float32).sum(), min=1.0)


def masked_mean(x: torch.Tensor, mask_b: torch.Tensor, count,
                dim: int = 0) -> torch.Tensor:
    """f32 mean of `x` over `dim` counting only rows where `mask_b` (a bool
    mask already broadcast against x)."""
    masked = torch.where(mask_b, x.to(torch.float32), 0.0)
    return masked.sum(dim=dim, keepdim=True) / count


def masked_abs_max(x: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
    """Scalar max |x| over surviving rows (dead rows count as 0): a shared
    quantization scale must ignore a dead replica's garbage."""
    return torch.where(mask_b, x.abs(), 0).max()


def rolling(x: torch.Tensor, target: torch.Tensor, alpha) -> torch.Tensor:
    """The paper's rolling update: step `alpha` of the way to `target`."""
    return x + alpha * (target.to(x.dtype) - x)


def ring_neighbor_indices(mask, shift=1) -> torch.Tensor:
    """(P,) int64 gather indices that re-stitch the gossip ring around
    dropped institutions: survivor i's neighbour is the survivor `shift`
    places behind it in the ring of survivors (``torch.roll(x, shift)``'s
    neighbour when every institution survives); a dead institution points
    at itself."""
    m = torch.as_tensor(mask).to(torch.bool)
    P = m.shape[0]
    idx = torch.arange(P, device=m.device)
    rank = torch.cumsum(m.to(torch.int64), 0) - 1   # rank among survivors
    count = torch.clamp(m.sum(), min=1)
    rank_to_idx = torch.zeros((P,), dtype=torch.int64, device=m.device)
    rank_to_idx[rank[m]] = idx[m]
    tgt = torch.remainder(rank - shift, count)
    return torch.where(m, rank_to_idx[tgt], idx)
