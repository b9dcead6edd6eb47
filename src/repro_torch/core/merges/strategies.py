"""Built-in merge strategies: ``mean`` and the paper's MPC ``secure_mean``.

Each exists as a keyword-argument function and as a registered
`MergeStrategy` adapting `MergeContext` onto it.  Both are
consensus-gated (`ctx.commit`) and participation-masked (`ctx.mask`).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.merges.base import MergeContext, register_merge
from repro_torch.core.merges.toolkit import (
    gate, mask_nd, masked_mean, rolling, survivor_count,
)
from repro_torch.core.secure_agg import secure_rolling_update_tree
from repro_torch.pytree import tree_map

Pytree = Any


def mean_merge(stacked: Pytree, commit=True, *, alpha: float = 1.0,
               mask: Optional[torch.Tensor] = None) -> Pytree:
    """Consensus-gated rolling update toward the federation mean (over the
    survivors when `mask` is given; non-survivors pass through)."""
    if mask is None:
        def merge(x):
            return rolling(x, x.mean(dim=0, keepdim=True), alpha)
        return gate(tree_map(merge, stacked), stacked, commit)

    m = torch.as_tensor(mask)
    count = survivor_count(m)

    def merge(x):
        mb = mask_nd(m.to(x.device), x).to(torch.bool)
        mean = masked_mean(x, mb, count.to(x.device))
        return torch.where(mb, rolling(x, mean, alpha), x)
    return gate(tree_map(merge, stacked), stacked, commit)


def secure_mean_merge(stacked: Pytree, commit=True, *, alpha: float, key,
                      mask=None, impl: str = "auto",
                      domain: str = "float") -> Pytree:
    """MPC path, fused: one (P, N) ravel of the stacked tree, one
    masked-rolling-update kernel pass (in-kernel PRG pads, aggregate, blend
    all P rows), then the consensus gate."""
    merged = secure_rolling_update_tree(stacked, alpha, key, mask=mask,
                                        impl=impl, domain=domain)
    return gate(merged, stacked, commit)


@register_merge("mean")
class MeanMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return mean_merge(stacked, ctx.commit, alpha=ctx.alpha, mask=ctx.mask)


@register_merge("secure_mean")
class SecureMeanMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        if ctx.key is None:
            raise ValueError("secure_mean needs ctx.key (the MPC round key)")
        return secure_mean_merge(stacked, ctx.commit, alpha=ctx.alpha,
                                 key=ctx.key, mask=ctx.mask,
                                 domain=ctx.domain)
