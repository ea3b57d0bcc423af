"""Rule-based sharding specs, the counterpart of ``repro.launch.shardings``.

The same rules, as functions of a shape and a mesh description
(:class:`MeshSpec`: axis names and sizes), returning tuples of axis names
(one entry a dimension: None, an axis name, or a tuple of names) where the
JAX module returns ``PartitionSpec``s.  The dry-run (``launch.dryrun``)
reads them to size each leaf on one device; nothing runs sharded.

* batch-bearing inputs: dim 0 over ``("pod", "data")`` (replicated when the
  global batch does not divide, e.g. long_500k's B=1);
* parameters: the largest non-scan dim divisible by the ``model`` axis size
  is sharded over ``model``; MoE expert dims take priority (expert
  parallelism when divisible); ``REPRO_PARAM_SHARD=fsdp`` also shards over
  ``data`` (FSDP/ZeRO-3);
* KV caches: batch over ``data``, then the longest remaining dim divisible
  by ``model`` (the sequence for a KV cache).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


@dataclass(frozen=True)
class MeshSpec:
    """A device mesh by its axis names and sizes (the shape of a JAX
    ``Mesh``'s ``axis_names`` and ``shape``)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int] = field(hash=False)

    @property
    def devices(self) -> int:
        return math.prod(self.shape[a] for a in self.axis_names)


def production_mesh(multi_pod: bool = False) -> MeshSpec:
    """JAX's production mesh: ``data`` 16 x ``model`` 16, and ``pod`` 2
    before them for ``--multi-pod``."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"),
                        {"pod": 2, "data": 16, "model": 16})
    return MeshSpec(("data", "model"), {"data": 16, "model": 16})


def one_card_mesh() -> MeshSpec:
    """One card: ``data`` 1 x ``model`` 1, nothing sharded."""
    return MeshSpec(("data", "model"), {"data": 1, "model": 1})


def data_axes(mesh: MeshSpec) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def data_size(mesh: MeshSpec) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def model_size(mesh: MeshSpec) -> int:
    return mesh.shape["model"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_spec(shape: Tuple[int, ...], mesh: MeshSpec, *,
               path_str: str = "") -> Spec:
    """Largest divisible non-leading dim -> ``model``; rest replicated.

    The leading dim of stacked towers (>= 3-D leaves) is the layer axis —
    never sharded.  MoE expert leaves (``w_gate``, ``w_up``, ``w_down`` of
    4 dims) prefer the expert axis.  ``path_str`` is the leaf's path in
    ``jax.tree_util.keystr`` form (:func:`keystr`).
    """
    n = model_size(mesh)
    nd = len(shape)
    if nd == 0:
        return ()
    start = 1 if nd >= 3 else 0
    cands = list(range(start, nd))
    expert = nd == 4 and any(w in path_str
                             for w in ("w_gate", "w_up", "w_down"))
    if expert:
        cands = [1, 3, 2]
    best = None
    for i in sorted(cands, key=lambda i: -shape[i]):
        if shape[i] % n == 0 and shape[i] >= n:
            best = i
            break
    if expert and shape[1] % n == 0:
        best = 1
    spec: list = [None] * nd
    if best is not None:
        spec[best] = "model"
    if os.environ.get("REPRO_PARAM_SHARD", "baseline") == "fsdp" \
            and best is not None:
        d = mesh.shape["data"]
        total = n * d
        if shape[best] % total == 0 and shape[best] >= total:
            spec[best] = ("data", "model")
        else:
            # the second-largest divisible dim takes 'data'
            for i in sorted((j for j in range(start, nd) if j != best),
                            key=lambda j: -shape[j]):
                if shape[i] % d == 0 and shape[i] >= d:
                    spec[i] = "data"
                    break
    return tuple(spec)


def keystr(path: Tuple[str, ...]) -> str:
    """A leaf's dict path as ``jax.tree_util.keystr`` writes it:
    ``['blocks']['mlp']['w_gate']``."""
    return "".join(f"[{k!r}]" for k in path)


# ---------------------------------------------------------------------------
# batches and caches
# ---------------------------------------------------------------------------

def batch_spec(shape: Tuple[int, ...], mesh: MeshSpec) -> Spec:
    d = data_size(mesh)
    if len(shape) >= 1 and shape[0] % d == 0 and shape[0] >= d:
        return (data_axes(mesh), *([None] * (len(shape) - 1)))
    return tuple([None] * len(shape))


def cache_spec(shape: Tuple[int, ...], mesh: MeshSpec) -> Spec:
    """KV cache (L, B, S, kv, hd) / ssm state (L, B, H, P, N) / conv
    (L, B, K, C) / pos (B,): batch over ``data`` when divisible; then the
    largest remaining dim divisible by ``model``."""
    d, m = data_size(mesh), model_size(mesh)
    nd = len(shape)
    spec: list = [None] * nd
    if nd == 1:
        return (None,)
    baxis = 1 if nd >= 3 else 0
    if shape[baxis] % d == 0 and shape[baxis] >= d:
        spec[baxis] = data_axes(mesh)
    cands = [i for i in range(nd) if i != baxis and i != 0]
    for i in sorted(cands, key=lambda i: -shape[i]):
        if shape[i] % m == 0 and shape[i] >= m:
            spec[i] = "model"
            break
    return tuple(spec)


# ---------------------------------------------------------------------------
# per-device sizes
# ---------------------------------------------------------------------------

def axis_size(entry: Axis, mesh: MeshSpec) -> int:
    """The number of shards one spec entry cuts its dimension into."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh.shape[a] for a in names)


def shard_shape(shape: Tuple[int, ...], spec: Spec,
                mesh: MeshSpec) -> Tuple[int, ...]:
    """A leaf's shape on one device under ``spec``."""
    return tuple(-(-dim // axis_size(e, mesh)) for dim, e in zip(shape, spec))


def shard_bytes(shape: Tuple[int, ...], itemsize: int, spec: Spec,
                mesh: MeshSpec) -> int:
    """A leaf's bytes on one device under ``spec``."""
    return math.prod(shard_shape(shape, spec, mesh)) * itemsize


def share(shape: Tuple[int, ...], spec: Spec, mesh: MeshSpec) -> float:
    """The fraction of a leaf one device holds under ``spec``."""
    whole = math.prod(shape)
    return math.prod(shard_shape(shape, spec, mesh)) / whole if whole else 1.0
