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
