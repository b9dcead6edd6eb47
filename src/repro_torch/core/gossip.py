"""Back-compat shim: the gossip collectives live in `core.merges`.

The five free functions keep the historical import surface working:

    from repro_torch.core import gossip
    gossip.mean_merge(stacked, commit, alpha=..., mask=...)

Every call routes its keyword arguments through a `MergeContext` and
dispatches via the registry (`core.merges.get_merge`), the path the
overlay takes, so shim output is registry output by construction: a
kwarg the context carries (``group_size``, ``shift``, ``alpha``,
``mask``, ``key``) reaches the strategy through the field the overlay
fills, and shadowing a built-in name with `@register_merge` redirects
the shim too.

Kwargs the context does not carry (`quantized`'s ``bits``,
`secure_mean`'s ``impl``) fall through to the strategy functions of
`core/merges/strategies.py`, which the registered strategies call
themselves: dropping them would change the numbers.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.merges import MergeContext, get_merge
from repro_torch.core.merges import strategies as _fn
from repro_torch.core.merges.toolkit import (
    gate as _gate, mask_nd as _mask_nd, ring_neighbor_indices,
)

Pytree = Any

__all__ = [
    "mean_merge", "ring_merge", "hierarchical_merge", "quantized_mean_merge",
    "secure_mean_merge", "ring_neighbor_indices", "_gate", "_mask_nd",
]


def _dispatch(name: str, stacked: Pytree, ctx: MergeContext) -> Pytree:
    return get_merge(name).merge(stacked, ctx)


def mean_merge(stacked: Pytree, commit=True, *, alpha: float = 1.0,
               mask: Optional[torch.Tensor] = None) -> Pytree:
    return _dispatch("mean", stacked,
                     MergeContext(commit=commit, mask=mask, alpha=alpha))


def ring_merge(stacked: Pytree, commit=True, *, shift=1, alpha: float = 0.5,
               mask: Optional[torch.Tensor] = None) -> Pytree:
    return _dispatch("ring", stacked,
                     MergeContext(commit=commit, mask=mask, alpha=alpha,
                                  shift=shift))


def hierarchical_merge(stacked: Pytree, commit=True, *, group_size: int,
                       alpha: float = 1.0,
                       mask: Optional[torch.Tensor] = None) -> Pytree:
    return _dispatch("hierarchical", stacked,
                     MergeContext(commit=commit, mask=mask, alpha=alpha,
                                  group_size=group_size))


def quantized_mean_merge(stacked: Pytree, commit=True, *, alpha: float = 1.0,
                         bits: int = 8,
                         mask: Optional[torch.Tensor] = None) -> Pytree:
    if bits != 8:   # not a MergeContext field: the registered strategy is
        # fixed at the 8-bit wire format
        return _fn.quantized_mean_merge(stacked, commit, alpha=alpha,
                                        bits=bits, mask=mask)
    return _dispatch("quantized", stacked,
                     MergeContext(commit=commit, mask=mask, alpha=alpha))


def secure_mean_merge(stacked: Pytree, commit=True, *, alpha: float, key,
                      mask: Optional[torch.Tensor] = None,
                      impl: str = "auto") -> Pytree:
    if impl != "auto":  # pins a backend (kernel tests)
        return _fn.secure_mean_merge(stacked, commit, alpha=alpha, key=key,
                                     mask=mask, impl=impl)
    return _dispatch("secure_mean", stacked,
                     MergeContext(commit=commit, mask=mask, alpha=alpha,
                                  key=key))
