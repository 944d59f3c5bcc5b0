"""Parameter pytrees: nested dicts of tensors, in ``jax.tree_util`` order.

A leaf's flat index matters (masks, densities and per-leaf telemetry are
lists in flatten order), so flattening walks dict keys SORTED, depth
first — exactly what ``jax.tree_util.tree_flatten`` does for dicts.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

TreeDef = Any   # None for a leaf, else (sorted keys, child treedefs)


def flatten(tree) -> Tuple[List, TreeDef]:
    leaves: List = []

    def rec(node):
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return keys, tuple(rec(node[k]) for k in keys)
        leaves.append(node)
        return None

    return leaves, rec(tree)


def unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def rec(td):
        if td is None:
            return next(it)
        keys, children = td
        return {k: rec(c) for k, c in zip(keys, children)}

    out = rec(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def leaves(tree) -> List:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and ``rest``."""
    ls, td = flatten(tree)
    others = [flatten(r) for r in rest]
    for ol, otd in others:
        if otd != td:
            raise ValueError("tree structure mismatch")
    return unflatten(td, [fn(*xs) for xs in zip(ls, *(o[0] for o in others))])
