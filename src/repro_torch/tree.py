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

:func:`named_leaves`, :func:`map_named`, :func:`named_values` and
:func:`unflatten_named` are the one other walk: the JAX package's, in
which a named tuple (``TrainState``, ``DecodeState``, a layer's state)
is a node walked field by field, each leaf named by the dict keys and
field names on its way (what ``repro.models.lm``'s ``_path_names`` reads
from a path).  They serve the partition specs, which the JAX package
keys on those names, and the placement of trees on a mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

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


def _flatten_rec(node, path: KeyPath, out: list) -> TreeDef:
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return None
    kind, keys, children = kids
    return kind, keys, tuple(_flatten_rec(c, path + ((kind, k),), out)
                             for k, c in zip(keys, children))


def flatten_with_path(tree) -> Tuple[List[Tuple[KeyPath, Any]], TreeDef]:
    """``[(path, leaf)]`` in flatten order, and the treedef.

    The walks here are module-level functions, not self-referencing
    closures: a closure that calls itself is a reference cycle, and one
    holding the leaves keeps every tensor of the tree alive until the
    cyclic garbage collector runs (tens of GB of stale parameters)."""
    out: List[Tuple[KeyPath, Any]] = []
    treedef = _flatten_rec(tree, (), out)
    return out, treedef


def keystr(path: KeyPath) -> str:
    """A path as ``jax.tree_util.keystr`` renders it: ``[repr(key)]`` for
    a dict key, ``[index]`` for a list index."""
    return "".join(f"[{k!r}]" if step == "dict" else f"[{k}]"
                   for step, k in path)


def flatten(tree) -> Tuple[List, TreeDef]:
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def _unflatten_rec(td: TreeDef, it):
    if td is None:
        return next(it)
    kind, keys, children = td
    vals = [_unflatten_rec(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, vals))
    return None if kind == "none" else vals


def unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)
    out = _unflatten_rec(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def _up_to_rec(td: TreeDef, node, out: list) -> None:
    if td is None:
        out.append(node)
        return
    kind, keys, children = td
    kids = _children(node)
    if kids is None or kids[0] != kind or kids[1] != keys:
        raise ValueError("tree structure mismatch")
    for c, n in zip(children, kids[2]):
        _up_to_rec(c, n, out)


def flatten_up_to(treedef: TreeDef, tree) -> List:
    """The subtrees of ``tree`` at the leaves of ``treedef`` (a prefix of
    ``tree``'s structure), in flatten order: ``jax``'s
    ``treedef.flatten_up_to``, e.g. an optimizer's per-leaf state dicts."""
    out: List = []
    _up_to_rec(treedef, tree, out)
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


def _is_named_tuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def named_leaves(node, names: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(names, leaf)`` in ``jax.tree_util`` order: dict keys sorted,
    lists in order, named tuples field by field; ``names`` are the dict
    keys and field names on the way.  ``None`` holds no leaf; a host int
    (``DecodeState.pos``) is one.  On a tree without named tuples the
    leaves are :func:`flatten`'s, in its order."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from named_leaves(node[k], names + (str(k),))
    elif isinstance(node, list):
        for v in node:
            yield from named_leaves(v, names)
    elif _is_named_tuple(node):
        for f, v in zip(node._fields, node):
            yield from named_leaves(v, names + (f,))
    elif node is not None:
        yield names, node


def map_named(fn: Callable, node, names: Tuple[str, ...] = ()):
    """``node`` with each leaf of :func:`named_leaves` replaced by
    ``fn(names, leaf)``, in the same structure.  ``fn`` is called in
    :func:`named_leaves` order (dict keys sorted); a dict keeps its
    insertion order."""
    if isinstance(node, dict):
        out = {k: map_named(fn, node[k], names + (str(k),))
               for k in sorted(node)}
        return {k: out[k] for k in node}
    if isinstance(node, list):
        return [map_named(fn, v, names) for v in node]
    if _is_named_tuple(node):
        return type(node)(*[map_named(fn, v, names + (f,))
                            for f, v in zip(node._fields, node)])
    return None if node is None else fn(names, node)


def named_values(node) -> List:
    """The leaves of :func:`named_leaves`, without their names."""
    return [leaf for _, leaf in named_leaves(node)]


def unflatten_named(like, values) -> Any:
    """``like`` with its :func:`named_values` replaced by ``values``, in
    that order: the inverse of :func:`named_values`."""
    values = list(values)
    it = iter(values)

    def _next(names, _leaf):
        try:
            return next(it)
        except StopIteration:
            raise ValueError(f"{len(values)} values for a tree with "
                             f"more leaves") from None

    out = map_named(_next, like)
    if next(it, it) is not it:
        raise ValueError(f"{len(values)} values for a tree with fewer "
                         f"leaves")
    return out
