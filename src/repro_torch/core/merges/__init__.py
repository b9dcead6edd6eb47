"""Pluggable merge engine of the overlay.

  base.py        MergeStrategy protocol, MergeContext, @register_merge
  toolkit.py     shared masked-reduce primitives (gate, masked mean)
  strategies.py  the built-ins ported so far: mean | secure_mean

Importing this package registers the built-ins.
"""
from repro_torch.core.merges.base import (
    MergeContext, MergeStrategy, available_merges, get_merge, register_merge,
)
from repro_torch.core.merges.strategies import (
    MeanMerge, SecureMeanMerge, mean_merge, secure_mean_merge,
)

__all__ = [
    "MergeContext", "MergeStrategy", "available_merges", "get_merge",
    "register_merge", "MeanMerge", "SecureMeanMerge", "mean_merge",
    "secure_mean_merge",
]
