"""Pluggable merge engine of the overlay.

  base.py        MergeStrategy protocol, MergeContext, @register_merge,
                 the gossip_shift schedule
  toolkit.py     shared masked-reduce primitives (gate, masked mean and
                 abs-max, ring re-stitch)
  strategies.py  mean | ring | hierarchical | hierarchical_device |
                 quantized | secure_mean
  robust.py      Byzantine-robust: trimmed_mean | coordinate_median |
                 norm_gated_mean
  partial.py     partial merges: BlockSpec, BlockSchedule and the
                 "partial" meta-strategy (unselected leaves pass through)

Importing this package registers the built-ins.
"""
from repro_torch.core.merges.base import (
    MergeContext, MergeStrategy, available_merges, get_merge, gossip_shift,
    register_merge,
)
from repro_torch.core.merges.partial import (
    BlockSchedule, BlockSpec, PartialMerge, leaf_path,
)
from repro_torch.core.merges.robust import (
    CoordinateMedianMerge, NormGatedMeanMerge, TrimmedMeanMerge,
    coordinate_median_merge, norm_gated_mean_merge, trimmed_mean_merge,
)
from repro_torch.core.merges.strategies import (
    HierarchicalDeviceMerge, HierarchicalMerge, MeanMerge,
    QuantizedMeanMerge, RingMerge, SecureMeanMerge,
    hierarchical_device_merge, hierarchical_merge, mean_merge,
    quantized_mean_merge, ring_merge, secure_mean_merge,
)
from repro_torch.core.merges.toolkit import (
    gate, mask_nd, masked_abs_max, masked_mean, ring_neighbor_indices,
    rolling, survivor_count,
)

__all__ = [
    "MergeContext", "MergeStrategy", "available_merges", "get_merge",
    "gossip_shift", "register_merge",
    "HierarchicalDeviceMerge", "HierarchicalMerge", "MeanMerge",
    "QuantizedMeanMerge", "RingMerge", "SecureMeanMerge",
    "hierarchical_device_merge", "hierarchical_merge", "mean_merge",
    "quantized_mean_merge", "ring_merge", "secure_mean_merge",
    "BlockSchedule", "BlockSpec", "PartialMerge", "leaf_path",
    "CoordinateMedianMerge", "NormGatedMeanMerge", "TrimmedMeanMerge",
    "coordinate_median_merge", "norm_gated_mean_merge", "trimmed_mean_merge",
    "gate", "mask_nd", "masked_abs_max", "masked_mean",
    "ring_neighbor_indices", "rolling", "survivor_count",
]
