"""Partial (block) merges: federate a subset of the parameter tree, e.g.
a shared backbone merged across institutions while each hospital keeps a
personal head trained on its own data alone.

  BlockSpec      partitions a param pytree into named blocks by leaf path
                 (prefix rules or predicates); frozen and hashable.
  BlockSchedule  per-round active-block groups (block-coordinate descent,
                 round-robin): round r merges only
                 ``groups[r % len(groups)]``; the overlay hands the merge
                 the round's (n_blocks,) bool row.
  PartialMerge   the registered ``"partial"`` meta-strategy: runs any
                 registered inner merge (``ctx.inner_merge``) on the
                 selected blocks' leaves; every unselected leaf comes back
                 as the same tensor object, touched by no op.

``block_spec=None``, and a selection that covers every leaf with no
schedule, delegate to the inner merge as it is, so such a run equals the
inner merge's bit for bit, and attests like it on the ledger.  Inner
merges that reduce across leaves (secure_mean's one ravel, the norm gate)
see every selected block's leaves even when the schedule turns a block
off for the round: the schedule decides whose merged values take effect.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.merges.base import (
    MergeContext, get_merge, register_merge,
)
from repro_torch.pytree import (
    leaf_path, tree_flatten, tree_flatten_with_path, tree_unflatten,
)

Pytree = Any
Matcher = Union[Tuple[str, ...], Callable[[str], bool]]

__all__ = ["BlockSchedule", "BlockSpec", "PartialMerge", "leaf_path"]


def _matches(matcher: Matcher, path: str) -> bool:
    if callable(matcher):
        return bool(matcher(path))
    return any(path == p or path.startswith(p + "/") for p in matcher)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Named partition of a param pytree by leaf path.

    ``rules`` is an ordered ``(block_name, matcher)`` tuple; a matcher is
    a tuple of path prefixes (``("conv",)`` claims ``conv/0/w``) or a
    ``path -> bool`` predicate.  The first matching rule wins; a leaf no
    rule claims falls into ``default``, or raises, so that a spec missing
    new layers cannot pass unnoticed.  The common two-block split::

        spec = BlockSpec.by_prefix(backbone="conv", head="head")
    """
    rules: Tuple[Tuple[str, Matcher], ...]
    default: Optional[str] = None

    def __post_init__(self):
        if not self.rules:
            raise ValueError("BlockSpec needs at least one (name, matcher) "
                             "rule")
        seen = set()
        for name, _ in self.rules:
            if name in seen:
                raise ValueError(f"duplicate block name {name!r} in "
                                 f"BlockSpec rules")
            seen.add(name)

    @classmethod
    def by_prefix(cls, default: Optional[str] = None,
                  **blocks: Union[str, Tuple[str, ...]]) -> "BlockSpec":
        """``by_prefix(backbone="conv", head="head")``: one block per
        keyword, each claiming the listed path prefix(es)."""
        rules = tuple(
            (name, p if isinstance(p, tuple) else (p,))
            for name, p in blocks.items())
        return cls(rules=rules, default=default)

    @property
    def block_names(self) -> Tuple[str, ...]:
        """All block names in rule order, ``default`` last if distinct:
        the axis of every (n_blocks,) schedule row."""
        names = [n for n, _ in self.rules]
        if self.default is not None and self.default not in names:
            names.append(self.default)
        return tuple(names)

    def block_index(self, name: str) -> int:
        try:
            return self.block_names.index(name)
        except ValueError:
            raise ValueError(f"unknown block {name!r}; spec defines "
                             f"{self.block_names}") from None

    def block_of(self, path: str) -> str:
        for name, matcher in self.rules:
            if _matches(matcher, path):
                return name
        if self.default is not None:
            return self.default
        raise ValueError(
            f"leaf path {path!r} matches no BlockSpec rule and the spec "
            f"has no default block (rules: "
            f"{tuple(n for n, _ in self.rules)})")

    def leaf_blocks(self, tree: Pytree) -> Tuple[str, ...]:
        """Block name of each leaf, in `tree_flatten` leaf order."""
        return tuple(self.block_of(leaf_path(p))
                     for p, _ in tree_flatten_with_path(tree)[0])

    def validate_blocks(self, blocks: Sequence[str]) -> Tuple[str, ...]:
        unknown = [b for b in blocks if b not in self.block_names]
        if unknown:
            raise ValueError(f"unknown blocks {unknown}; spec defines "
                             f"{self.block_names}")
        return tuple(blocks)

    def covers(self, tree: Pytree, blocks: Sequence[str]) -> bool:
        """True iff selecting `blocks` selects every leaf of `tree`."""
        return set(self.leaf_blocks(tree)) <= set(blocks)

    def select_tree(self, tree: Pytree, blocks: Sequence[str]) -> Pytree:
        """The shared view of `tree` under a block selection: the tree
        itself when the selection covers every leaf, else a ``{path:
        leaf}`` dict of the selected leaves alone, the view the ledger
        attests (free of any personal block's rows)."""
        picked = {}
        covered = True
        for p, leaf in tree_flatten_with_path(tree)[0]:
            path = leaf_path(p)
            if self.block_of(path) in blocks:
                picked[path] = leaf
            else:
                covered = False
        return tree if covered else picked


@dataclasses.dataclass(frozen=True)
class BlockSchedule:
    """Block-coordinate rotation: round r merges exactly the blocks in
    ``groups[r % len(groups)]``; every other selected block keeps its
    local params for the round."""
    groups: Tuple[Tuple[str, ...], ...]

    def __post_init__(self):
        if not self.groups or any(not g for g in self.groups):
            raise ValueError("BlockSchedule needs non-empty block groups")

    @classmethod
    def round_robin(cls, names: Sequence[str]) -> "BlockSchedule":
        """One block a round, cycling: the classic block-coordinate
        descent sweep."""
        return cls(groups=tuple((n,) for n in names))

    def active(self, round_index: int) -> Tuple[str, ...]:
        return self.groups[int(round_index) % len(self.groups)]

    def mask_row(self, spec: BlockSpec, round_index: int) -> np.ndarray:
        """Host (n_blocks,) bool row over ``spec.block_names``."""
        active = set(self.active(round_index))
        return np.asarray([n in active for n in spec.block_names], bool)


@register_merge("partial")
class PartialMerge:
    """Meta-strategy: ``ctx.inner_merge`` on the leaves of the blocks that
    ``ctx.blocks`` selects (all of ``ctx.block_spec``'s when None);
    unselected leaves pass through untouched.  With ``ctx.block_mask``
    (the schedule's row, a host bool array), a selected block whose bit is
    off keeps its original leaves this round."""

    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        if ctx.inner_merge == "partial":
            raise ValueError("partial merge cannot nest itself as "
                             "inner_merge")
        inner = get_merge(ctx.inner_merge)
        spec = ctx.block_spec
        if spec is None:
            return inner.merge(stacked, ctx)
        leaf_blk = spec.leaf_blocks(stacked)
        selected = (spec.block_names if ctx.blocks is None
                    else spec.validate_blocks(ctx.blocks))
        sel = [b in selected for b in leaf_blk]
        if all(sel) and ctx.block_mask is None:
            # full coverage, no schedule: the inner merge sees the same
            # tree, so the result is its own bit for bit
            return inner.merge(stacked, ctx)
        leaves, spec_tree = tree_flatten(stacked)
        sub = tuple(leaf for leaf, s in zip(leaves, sel) if s)
        if not sub:
            raise ValueError(
                f"blocks {tuple(selected)} select no leaves; leaf blocks "
                f"are {sorted(set(leaf_blk))}")
        merged_sub = iter(tree_flatten(inner.merge(sub, ctx))[0])
        out = []
        for leaf, s, bname in zip(leaves, sel, leaf_blk):
            merged = next(merged_sub) if s else leaf
            if s and ctx.block_mask is not None and \
                    not bool(ctx.block_mask[spec.block_index(bname)]):
                merged = leaf    # scheduled off this round
            out.append(merged)
        return tree_unflatten(spec_tree, out)
