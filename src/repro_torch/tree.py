"""Parameter pytrees: nested dicts and lists of tensors, in
``jax.tree_util`` order.

A leaf's flat index matters (masks, densities and per-leaf telemetry are
lists in flatten order), so flattening walks dict keys SORTED and lists
in order, depth first — exactly what ``jax.tree_util.tree_flatten`` does.
``None`` is an empty node, as in jax.  Unlike jax, a tuple is a leaf (a
shape, a named tuple such as a KV cache).  :func:`keystr` renders a
leaf's path as ``jax.tree_util.keystr`` does (``"['fc0']['w']"``,
``"[1]"``): coverage tables and ``always_upload`` predicates are keyed on
those strings.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

TreeDef = Any   # None for a leaf, else (kind, keys, child treedefs)
KeyPath = Tuple  # (('dict', key) | ('list', index), ...)


def _children(node):
    """(kind, keys, children) of a container node, or None for a leaf."""
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return "dict", keys, [node[k] for k in keys]
    if isinstance(node, list):
        return "list", tuple(range(len(node))), node
    if node is None:
        return "none", (), []
    return None


def flatten_with_path(tree) -> Tuple[List[Tuple[KeyPath, Any]], TreeDef]:
    """``[(path, leaf)]`` in flatten order, and the treedef."""
    out: List[Tuple[KeyPath, Any]] = []

    def rec(node, path):
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return None
        kind, keys, children = kids
        return kind, keys, tuple(rec(c, path + ((kind, k),))
                                 for k, c in zip(keys, children))

    return out, rec(tree, ())


def keystr(path: KeyPath) -> str:
    """A path as ``jax.tree_util.keystr`` renders it: ``[repr(key)]`` for
    a dict key, ``[index]`` for a list index."""
    return "".join(f"[{k!r}]" if step == "dict" else f"[{k}]"
                   for step, k in path)


def flatten(tree) -> Tuple[List, TreeDef]:
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def rec(td):
        if td is None:
            return next(it)
        kind, keys, children = td
        vals = [rec(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, vals))
        return None if kind == "none" else vals

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
