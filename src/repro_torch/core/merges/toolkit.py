"""Shared masked-reduce primitives for merge strategies: the consensus
gate, mask broadcasting, the survivor count, mean and abs-max, the
rolling update and the ring re-stitched around dead institutions.

Every helper excludes dead rows with ``where()`` rather than
multiplication, so a dropped institution holding inf/NaN cannot poison
the survivors' reduction (``inf * 0`` is NaN).

The count, mean and abs-max take ``group=``, the port of the JAX
package's ``axis_name=``: a rank passes its own block of rows and the
process group of the institution axis, and the local sum or max is
``all_reduce``d (SUM, MAX) over it, so every rank gets the global value.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.pytree import tree_map
from repro_torch.sharding.api import host_staged

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


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """`t` reduced over `group` (a no-op for None), on `t`'s device."""
    if group is None:
        return t
    staged = host_staged(t, group)
    dist.all_reduce(staged, op=op, group=group)
    return staged.to(t.device)


def survivor_count(mask: torch.Tensor, *, group=None) -> torch.Tensor:
    """f32 survivor count, clamped to >= 1 so an all-dead round cannot
    divide by zero.  With `group`, `mask` is this rank's block and the
    count is summed over the group."""
    local = _all_reduce(mask.to(torch.float32).sum(), dist.ReduceOp.SUM,
                        group)
    return torch.clamp(local, min=1.0)


def masked_mean(x: torch.Tensor, mask_b: torch.Tensor, count,
                dim: int = 0, *, group=None) -> torch.Tensor:
    """f32 mean of `x` over `dim` counting only rows where `mask_b` (a bool
    mask already broadcast against x).  With `group`, the masked sum of
    this rank's rows is summed over the group first."""
    masked = torch.where(mask_b, x.to(torch.float32), 0.0)
    total = _all_reduce(masked.sum(dim=dim, keepdim=True),
                        dist.ReduceOp.SUM, group)
    return total / count


def masked_abs_max(x: torch.Tensor, mask_b: torch.Tensor, *,
                   group=None) -> torch.Tensor:
    """Scalar max |x| over surviving rows (dead rows count as 0): a shared
    quantization scale must ignore a dead replica's garbage.  With
    `group`, the max over the group's rows."""
    return _all_reduce(torch.where(mask_b, x.abs(), 0).max(),
                       dist.ReduceOp.MAX, group)


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
