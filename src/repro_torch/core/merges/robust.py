"""Byzantine-robust merge strategies: they bound the damage that poisoned
institutions (sign-flipped or scaled updates, label-flipped data) can do
to the federation.

  trimmed_mean       per coordinate: sort the institution axis, drop the
                     top and bottom ``floor(trim_fraction * survivors)``
                     values, average the middle.
  coordinate_median  per coordinate: the survivors' median (the two middle
                     ranks averaged for an even count).
  norm_gated_mean    whole rows: rows whose update L2 norm exceeds
                     ``norm_gate_factor x median(survivor norms)`` are left
                     out of the mean, and are themselves reset to it.

Like the other strategies they are consensus-gated (`ctx.commit`) and
participation-masked (`ctx.mask`: dead rows are left out and pass through
bit for bit).  At ``alpha == 1`` every surviving row is set to the robust
aggregate itself, not to ``x + (agg - x)``, so a live attacker row holding
+/-inf or NaN cannot poison itself through the blend.  Degenerate knobs
are the plain mean: a trim count of 0 (unmasked), or ``norm_gate_factor``
None or inf, delegate to `mean_merge`.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.core.merges.base import MergeContext, register_merge
from repro_torch.core.merges.strategies import mean_merge
from repro_torch.core.merges.toolkit import (
    gate, mask_nd, masked_mean, rolling, survivor_count,
)
from repro_torch.pytree import tree_flatten, tree_map

Pytree = Any


def _blend(x: torch.Tensor, agg: torch.Tensor, alpha: float) -> torch.Tensor:
    """Rolling update toward the robust aggregate; at alpha == 1 the row
    becomes the aggregate (x + 1 * (agg - x) is NaN for x = +/-inf, and
    the row that most needs overwriting is the attacker's)."""
    if alpha == 1.0:
        return agg.to(torch.float32).expand(x.shape).contiguous()
    return rolling(x, agg, alpha)


def _median_rank_bounds(count: torch.Tensor):
    """(lo, hi) sorted ranks of the median of `count` survivors, as (1,)
    int64 tensors: lo == hi for an odd count, the two middle ranks for an
    even one."""
    ci = torch.clamp(count.to(torch.int64), min=1).reshape(1)
    return (ci - 1) // 2, ci // 2


def _sorted_alive(x: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
    """x in f32 sorted along the institution axis, dead rows pushed to
    +inf (NaN sorts last, as in XLA)."""
    return torch.sort(torch.where(mb, x.to(torch.float32), math.inf),
                      dim=0).values


def trimmed_mean_merge(stacked: Pytree, commit=True, *,
                       trim_fraction: float = 0.25, alpha: float = 1.0,
                       mask: Optional[torch.Tensor] = None) -> Pytree:
    """The coordinate-wise trimmed mean over the institution axis.  Dead
    rows are pushed to +inf before the sort, so they fall outside the
    survivors' window, and a live attacker's +/-inf or NaN lands in the
    trimmed tails.  Unmasked, a trim count of 0 is `mean_merge`."""
    if not 0.0 <= trim_fraction < 0.5:
        raise ValueError(f"trim_fraction must be in [0, 0.5), "
                         f"got {trim_fraction}")
    P = tree_flatten(stacked)[0][0].shape[0]

    if mask is None:
        t = int(math.floor(trim_fraction * P))
        if t == 0:
            return mean_merge(stacked, commit, alpha=alpha)

        def merge(x):
            xs = torch.sort(x.to(torch.float32), dim=0).values
            agg = xs[t:P - t].mean(dim=0, keepdim=True)
            return _blend(x, agg, alpha)
        return gate(tree_map(merge, stacked), stacked, commit)

    m = torch.as_tensor(mask).to(torch.bool)
    c = survivor_count(m)
    t = torch.floor(torch.tensor(trim_fraction, dtype=torch.float32,
                                 device=c.device) * c)
    cnt = torch.clamp(c - 2.0 * t, min=1.0)

    def merge(x):
        mb = mask_nd(m.to(x.device), x)
        xs = _sorted_alive(x, mb)
        rank = torch.arange(P, dtype=torch.float32, device=x.device).reshape(
            (P,) + (1,) * (x.dim() - 1))
        tx, cx = t.to(x.device), c.to(x.device)
        win = (rank >= tx) & (rank < cx - tx)
        agg = torch.where(win, xs, 0.0).sum(dim=0, keepdim=True) / \
            cnt.to(x.device)
        return torch.where(mb, _blend(x, agg, alpha), x)
    return gate(tree_map(merge, stacked), stacked, commit)


def coordinate_median_merge(stacked: Pytree, commit=True, *,
                            alpha: float = 1.0,
                            mask: Optional[torch.Tensor] = None) -> Pytree:
    """The coordinate-wise median of the survivors (an even count averages
    the two middle ranks): the strongest per-coordinate guarantee (f < P/2
    attackers), with more bias than the trimmed mean when all are
    honest."""
    P = tree_flatten(stacked)[0][0].shape[0]

    if mask is None:
        lo, hi = (P - 1) // 2, P // 2

        def merge(x):
            xs = torch.sort(x.to(torch.float32), dim=0).values
            agg = (0.5 * (xs[lo] + xs[hi]))[None]
            return _blend(x, agg, alpha)
        return gate(tree_map(merge, stacked), stacked, commit)

    m = torch.as_tensor(mask).to(torch.bool)
    lo, hi = _median_rank_bounds(m.sum())

    def merge(x):
        mb = mask_nd(m.to(x.device), x)
        xs = _sorted_alive(x, mb)
        agg = 0.5 * (xs.index_select(0, lo.to(x.device))
                     + xs.index_select(0, hi.to(x.device)))
        return torch.where(mb, _blend(x, agg, alpha), x)
    return gate(tree_map(merge, stacked), stacked, commit)


def _row_sq_norm(leaf: torch.Tensor) -> torch.Tensor:
    """(P,) sum of squares of each institution's row of one leaf."""
    sq = torch.square(leaf.to(torch.float32))
    return sq if leaf.dim() == 1 else sq.sum(dim=tuple(range(1, leaf.dim())))


def norm_gated_mean_merge(stacked: Pytree, commit=True, *,
                          norm_gate_factor: Optional[float] = 3.0,
                          alpha: float = 1.0,
                          mask: Optional[torch.Tensor] = None) -> Pytree:
    """The mean over rows whose whole-tree norm passes ``norm <=
    norm_gate_factor * median(survivor norms)``.  A row that fails it (a
    non-finite norm always fails) enters no reduction and is reset to the
    gated mean.  ``norm_gate_factor`` None or inf is `mean_merge`; if the
    gate rejects every survivor, the round is the identity."""
    if norm_gate_factor is None or math.isinf(norm_gate_factor):
        return mean_merge(stacked, commit, alpha=alpha, mask=mask)
    if norm_gate_factor <= 0.0:
        raise ValueError(f"norm_gate_factor must be > 0, "
                         f"got {norm_gate_factor}")
    leaves = tree_flatten(stacked)[0]
    P, dev = leaves[0].shape[0], leaves[0].device
    m = (torch.ones((P,), dtype=torch.bool, device=dev) if mask is None
         else torch.as_tensor(mask).to(device=dev, dtype=torch.bool))

    norm = torch.sqrt(sum(_row_sq_norm(leaf) for leaf in leaves))  # (P,)
    ns = torch.sort(torch.where(m, norm, math.inf)).values
    lo, hi = _median_rank_bounds(m.sum())
    med = 0.5 * (ns.index_select(0, lo) + ns.index_select(0, hi))
    accept = m & (norm <= torch.tensor(norm_gate_factor, dtype=torch.float32,
                                       device=dev) * med)
    any_ok = accept.any()
    cnt = torch.clamp(accept.sum().to(torch.float32), min=1.0)

    def merge(x):
        ab = mask_nd(accept, x)
        agg = masked_mean(x, ab, cnt)
        out = torch.where(ab, _blend(x, agg, alpha), agg.expand(x.shape))
        out = torch.where(mask_nd(m, x), out, x)     # dead rows untouched
        return torch.where(any_ok, out, x)
    return gate(tree_map(merge, stacked), stacked, commit)


@register_merge("trimmed_mean")
class TrimmedMeanMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return trimmed_mean_merge(stacked, ctx.commit,
                                  trim_fraction=ctx.trim_fraction,
                                  alpha=ctx.alpha, mask=ctx.mask)


@register_merge("coordinate_median")
class CoordinateMedianMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return coordinate_median_merge(stacked, ctx.commit, alpha=ctx.alpha,
                                       mask=ctx.mask)


@register_merge("norm_gated_mean")
class NormGatedMeanMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return norm_gated_mean_merge(stacked, ctx.commit,
                                     norm_gate_factor=ctx.norm_gate_factor,
                                     alpha=ctx.alpha, mask=ctx.mask)
