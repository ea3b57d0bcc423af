"""Nested dicts of tensors: the port's counterpart of ``jax.tree``.

Parameter, gradient and optimizer-state trees are plain nested dicts with the
JAX package's keys.  Leaves are visited in sorted key order at every level,
the order ``jax.tree.leaves`` uses for dicts, so sums over leaves add in the
same order in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Tree = Any


def leaves(tree: Tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def leaves_with_path(tree: Tree, prefix: Tuple[str, ...] = ()
                     ) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_path(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001
    """``fn`` over the leaves of trees of one structure -> a tree, visiting
    the leaves in the order of :func:`leaves`."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def clone(tree: Tree) -> Dict[str, Any]:
    """A detached copy of every tensor leaf."""
    return map(lambda t: t.detach().clone(), tree)


# ---- flattening: the counterpart of ``jax.tree_util.tree_flatten`` -------
# A treedef is a nested tuple: ("dict", keys, children) for a dict,
# ("seq", type, children) for a tuple, list or NamedTuple, _INT for a Python
# int leaf (the port's host-int Adam step, a 0-d int32 array in JAX) and
# _LEAF for any other leaf.
_LEAF, _INT = "leaf", "int"


def flatten(tree: Tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) of a tree of dicts, tuples, lists and NamedTuples,
    in the order ``jax.tree_util.tree_flatten`` gives: sorted dict keys,
    sequence order.  Python ints are leaves of their own kind."""
    out: List[Any] = []

    def go(x):
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return ("dict", keys, tuple(go(x[k]) for k in keys))
        if isinstance(x, (tuple, list)):
            return ("seq", type(x), tuple(go(c) for c in x))
        out.append(x)
        return _INT if isinstance(x, int) else _LEAF

    return out, go(tree)


def unflatten(treedef: Any, leaves: List[Any]) -> Tree:
    """The inverse of :func:`flatten`; an int leaf comes back as ``int(x)``
    (so a 0-d tensor restores the port's host-int step)."""
    it = iter(leaves)

    def go(d):
        if d == _LEAF:
            return next(it)
        if d == _INT:
            return int(next(it))
        kind, meta, children = d
        if kind == "dict":
            return {k: go(c) for k, c in zip(meta, children)}
        vals = [go(c) for c in children]
        return meta._make(vals) if hasattr(meta, "_fields") else meta(vals)

    tree = go(treedef)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the treedef holds")
    return tree
