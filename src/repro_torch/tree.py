"""Nested dicts of tensors: the port's counterpart of ``jax.tree``.

Parameter, gradient and optimizer-state trees are plain nested dicts with the
JAX package's keys.  Leaves are visited in sorted key order at every level,
the order ``jax.tree.leaves`` uses for dicts, so sums over leaves add in the
same order in both packages.

:func:`device_get` is the counterpart of ``jax.device_get``: the explicit
drain of device values to the host.  It runs in an :func:`explicit` section,
where ``repro_torch.analysis.runtime.sync_free`` lets host reads through and,
on the card, ``torch.cuda.set_sync_debug_mode`` is lifted for its length.
The trainer's and the window's host reads all go through it, and the few
deliberate synchronizes (a CUDA graph's capture) take an explicit section of
their own; :data:`explicit_counts` counts the sections by what they were for.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

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


# ---- the explicit drain: the counterpart of ``jax.device_get`` -----------
_EXPLICIT = threading.local()
#: explicit sections entered, by what they were for ("drain" for each
#: :func:`device_get`)
explicit_counts: "collections.Counter[str]" = collections.Counter()


def in_explicit_section() -> bool:
    """Whether this thread is inside an :func:`explicit` section."""
    return getattr(_EXPLICIT, "depth", 0) > 0


@contextlib.contextmanager
def explicit(what: str) -> Iterator[None]:
    """A section whose host reads and synchronizes are intended: counted in
    :data:`explicit_counts` under ``what``, let through by the runtime guard,
    and on the card run with the sync debug mode off (restored after)."""
    explicit_counts[what] += 1
    _EXPLICIT.depth = getattr(_EXPLICIT, "depth", 0) + 1
    mode = 0
    if torch.cuda.is_initialized():
        mode = torch.cuda.get_sync_debug_mode()
        if mode:
            torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)
        _EXPLICIT.depth -= 1


def _host(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        vals = [_host(v) for v in x]
        return type(x)._make(vals) if hasattr(type(x), "_fields") \
            else type(x)(vals)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:     # numpy has no bf16: widen exactly
            x = x.float()
        return x.cpu().numpy()
    return x


def device_get(tree: Tree) -> Any:
    """A tensor, or a tree (dicts, tuples, lists) of them, as numpy arrays
    on the host, in one explicit section (bf16 widened to fp32); other
    leaves pass through.  The explicit drain: ``jax.device_get``."""
    with explicit("drain"):
        return _host(tree)


def host_float(x: Any) -> float:
    """A 0-d tensor (or number) as a Python float, through
    :func:`device_get`."""
    return float(np.asarray(device_get(x)))
