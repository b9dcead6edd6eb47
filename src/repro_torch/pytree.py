"""Pytrees of tensors (nested dicts, lists and tuples) in the JAX
package's conventions: leaves in ``jax.tree`` order (dict keys sorted, then
list and tuple order), ``str(treedef)`` reproduced byte for byte, because
the ravel order and the ledger fingerprints depend on both, and leaf
paths joined as the JAX package's partial merges join them."""
from __future__ import annotations

from typing import Any, List, Tuple

Pytree = Any


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in the JAX package's order (dict keys sorted, then list and
    tuple order) and a structure spec for `tree_unflatten`."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, specs = [], []
        for k in keys:
            sub, spec = tree_flatten(tree[k])
            leaves += sub
            specs.append(spec)
        return leaves, ("dict", tuple(keys), tuple(specs))
    if isinstance(tree, (list, tuple)):
        leaves, specs = [], []
        for v in tree:
            sub, spec = tree_flatten(v)
            leaves += sub
            specs.append(spec)
        return leaves, (type(tree).__name__, None, tuple(specs))
    if tree is None:
        return [], ("none", None, ())
    return [tree], ("leaf", None, ())


def tree_unflatten(spec, leaves) -> Pytree:
    it = iter(leaves)

    def build(s):
        kind, keys, subs = s
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        children = [build(c) for c in subs]
        if kind == "dict":
            return dict(zip(keys, children))
        return children if kind == "list" else tuple(children)
    return build(spec)


def treedef_str(spec) -> str:
    """``str(jax.tree.structure(tree))`` for the same tree, e.g.
    ``PyTreeDef({'conv': [{'b': *, 'w': *}], 'head': {'b': *, 'w': *}})``."""
    def fmt(s):
        kind, keys, subs = s
        if kind == "leaf":
            return "*"
        if kind == "none":
            return "None"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(c)}"
                                   for k, c in zip(keys, subs)) + "}"
        inner = ", ".join(fmt(c) for c in subs)
        if kind == "list":
            return f"[{inner}]"
        return f"({inner},)" if len(subs) == 1 else f"({inner})"
    return f"PyTreeDef({fmt(spec)})"


def tree_map(fn, tree, *rest) -> Pytree:
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """((path, leaf) pairs in `tree_flatten`'s leaf order, spec).  A path
    is the tuple of dict keys and sequence positions from the root down to
    the leaf."""
    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from walk(v, path + (i,))
        elif t is not None:
            yield path, t
    return list(walk(tree, ())), tree_flatten(tree)[1]


def leaf_path(path) -> str:
    """A path from `tree_flatten_with_path` joined with "/": dict keys
    verbatim, sequence positions as their index, so ``{"conv": [{"w":
    ...}]}``'s leaf is ``conv/0/w``."""
    return "/".join(str(k) for k in path)
