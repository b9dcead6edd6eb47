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
    n_institutions  P
    domain          secure-aggregation arithmetic domain: "float" (pads
                    cancel to fp32 rounding) or "int" (exact Z_2^32 pads)
    """
    commit: Any = True
    mask: Optional[Any] = None
    alpha: float = 1.0
    round_index: int = 0
    key: Optional[Any] = None
    n_institutions: Optional[int] = None
    domain: str = "float"


@runtime_checkable
class MergeStrategy(Protocol):
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        """Return the merged stacked tree (same structure/shapes/dtypes)."""
        ...


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
