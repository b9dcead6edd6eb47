"""Merge-strategy protocol, round context and the pluggable registry.

A merge strategy is one object with ``merge(stacked, ctx) -> stacked``,
where `stacked` is the federated param pytree with a leading (P, ...)
institution axis and `ctx` the round's `MergeContext`:

    @register_merge("my_merge")
    class MyMerge:
        def merge(self, stacked, ctx):
            ...  # use ctx.mask / ctx.alpha / ctx.commit

Plain functions with the same signature can be registered too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, Tuple, runtime_checkable

Pytree = Any


@dataclasses.dataclass(frozen=True)
class MergeContext:
    """Everything a merge strategy may consume for ONE overlay round.

    commit          consensus outcome: a rejected round must leave every
                    institution untouched
    mask            optional (P,) participation mask; None = everyone, and
                    strategies keep None bit-identical to their unmasked
                    behaviour
    alpha           rolling-update blend toward the merged model
    round_index     overlay round number
    key             per-round threefry key (secure_mean derives the MPC
                    round seed from it)
    group_size      hierarchical-merge group width
    shift           the round's gossip ring shift (`gossip_shift`), set by
                    the overlay so both engines cycle the ring alike
    n_institutions  P
    trim_fraction   the trimmed mean's share of rows dropped from EACH end
                    of the sorted institution axis; small enough that no
                    row is dropped, it is the plain mean
    norm_gate_factor  the norm-gated mean rejects rows whose update norm
                    exceeds this multiple of the survivors' median norm;
                    None or inf never gates
    domain          secure-aggregation arithmetic domain: "float" (pads
                    cancel to fp32 rounding) or "int" (exact Z_2^32 pads)
    device_weights  optional (P,) per-institution device-weight totals of
                    this round (a tensor on the rows' device): the summed
                    sample counts of each institution's device
                    sub-federation.  The ``hierarchical_device`` merge
                    weights the institution mean by them; None = no device
                    tier, and strategies keep None bit-identical to the
                    plain mean
    block_spec      optional `merges.partial.BlockSpec`: the named
                    partition of the param tree the ``partial`` merge
                    splits on; None makes it delegate to its inner merge
    blocks          the selected block names the partial merge federates;
                    None selects every block of the spec
    inner_merge     registry name of the strategy the partial merge runs
                    on the selected leaves (never "partial")
    block_mask      optional (n_blocks,) bool row over
                    ``block_spec.block_names``, the round's block schedule:
                    a selected block whose bit is off keeps its local
                    params this round; None merges every selected block
    """
    commit: Any = True
    mask: Optional[Any] = None
    alpha: float = 1.0
    round_index: int = 0
    key: Optional[Any] = None
    group_size: int = 2
    shift: Any = 1
    n_institutions: Optional[int] = None
    trim_fraction: float = 0.25
    norm_gate_factor: Optional[float] = 3.0
    domain: str = "float"
    device_weights: Optional[Any] = None
    block_spec: Optional[Any] = None
    blocks: Optional[Tuple[str, ...]] = None
    inner_merge: str = "mean"
    block_mask: Optional[Any] = None


@runtime_checkable
class MergeStrategy(Protocol):
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        """Return the merged stacked tree (same structure/shapes/dtypes)."""
        ...


def gossip_shift(round_index: int, n_institutions: int) -> int:
    """The overlay's gossip schedule: the ring shift of `round_index`,
    cycling 1, 2, ..., P-1, 1, ... so that repeated ring hops visit every
    neighbour; P = 2 always talks to its one peer."""
    return 1 + round_index % max(n_institutions - 1, 1)


@dataclasses.dataclass(frozen=True)
class _FunctionStrategy:
    """Adapter giving a bare (stacked, ctx) callable the protocol shape."""
    fn: Callable[[Pytree, MergeContext], Pytree]

    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return self.fn(stacked, ctx)


_REGISTRY: Dict[str, MergeStrategy] = {}


def register_merge(name: str):
    """Class/function decorator making a strategy addressable as
    ``OverlayConfig(merge=name)``.  Re-registering a name overwrites it."""
    def deco(obj):
        if isinstance(obj, type):
            strategy = obj()
        elif hasattr(obj, "merge"):
            strategy = obj
        else:
            strategy = _FunctionStrategy(obj)
        _REGISTRY[name] = strategy
        return obj
    return deco


def get_merge(name: str) -> MergeStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown merge {name!r}; registered: {available_merges()}"
        ) from None


def available_merges() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
