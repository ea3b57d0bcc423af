"""Dtype-preserving tree codec for the state store.

The counterpart of ``repro.statestore.codec``, writing the same format: an
``.npz`` archive whose ``raw_<i>`` members hold each leaf's little-endian
bytes (``uint8``) and whose ``__manifest__`` member is the JSON manifest
(version 1, each leaf's dtype by its numpy / ``ml_dtypes`` name and its
shape).  So either package reads the other's files, bf16 leaves included:
the bytes travel raw, and the names map to torch dtypes through a table
(no ``ml_dtypes`` needed).

A :class:`Snapshot` holds host tensors that the snapshot owns.  The
trainer's state is updated in place, so a snapshot that shared memory with
it (``t.cpu()`` of a CPU tensor is the tensor itself) would be overwritten
by the next Adam step; :func:`host_snapshot` always copies.  Leaves are
listed in ``jax.tree_util.tree_flatten``'s order (``tree.flatten``), the
port's host-int Adam step as a 0-d int32 tensor, as JAX stores it.
"""
from __future__ import annotations

import io
import json
import zipfile
from dataclasses import dataclass, field
from typing import Any, BinaryIO, List, Optional

import numpy as np
import torch

from repro_torch import tree as TR

Pytree = Any

MANIFEST_KEY = "__manifest__"
_FORMAT_VERSION = 1

#: dtype names of the manifest (numpy's and ``ml_dtypes``') -> torch dtypes
DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "uint16": torch.uint16, "int16": torch.int16, "uint32": torch.uint32,
    "int32": torch.int32, "uint64": torch.uint64, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}


class CodecError(RuntimeError):
    """A snapshot could not be encoded/decoded or does not match its
    template (corrupted file, missing leaves, shape/dtype mismatch)."""


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise CodecError(f"no manifest name for {dtype}") from None


def _resolve_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise CodecError(f"cannot resolve dtype {name!r}") from None


@dataclass
class Snapshot:
    """One host-resident copy of a tree (or leaves decoded from a file)."""

    shard_id: str                       # "full" or "stage<k>"
    step: int                           # effective step the state belongs to
    leaves: List[torch.Tensor]          # owned host tensors, original dtypes
    treedef: Optional[Any] = None       # None when decoded without a template
    meta: dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self.leaves))


def host_snapshot(tree: Pytree, *, step: int, shard_id: str) -> Snapshot:
    """Device -> host copy of every leaf, dtype preserved, into tensors the
    snapshot owns.

    Leaves on the card are copied into pinned host buffers with
    ``copy_(non_blocking=True)``, all queued before one synchronize, so the
    copies run back to back; CPU leaves are cloned.  This is the only part
    of a save that must happen before the next train step (which updates
    the state in place); serialization and tier I/O can run behind it.
    """
    leaves, treedef = TR.flatten(tree)
    host, on_card = [], False
    for x in leaves:
        if isinstance(x, int):
            host.append(torch.tensor(x, dtype=torch.int32))
        elif x.device.type == "cpu":
            host.append(x.detach().clone(memory_format=torch.contiguous_format))
        else:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x.detach(), non_blocking=True)
            host.append(buf)
            on_card = True
    if on_card:
        torch.cuda.synchronize()
    return Snapshot(shard_id=shard_id, step=step, leaves=host,
                    treedef=treedef)


def _template_dtype(ref: Any) -> torch.dtype:
    return torch.int32 if isinstance(ref, int) else ref.dtype


def snapshot_to_tree(snap: Snapshot, template: Optional[Pytree] = None,
                     ) -> Pytree:
    """Rebuild the tree (of the snapshot's own host tensors; int leaves as
    ints), validating against ``template`` when given."""
    if template is not None:
        t_leaves, treedef = TR.flatten(template)
        if len(t_leaves) != len(snap.leaves):
            raise CodecError(
                f"snapshot {snap.shard_id}@{snap.step} has "
                f"{len(snap.leaves)} leaves, template has {len(t_leaves)}")
        for i, (ref, got) in enumerate(zip(t_leaves, snap.leaves)):
            shape = () if isinstance(ref, int) else tuple(ref.shape)
            if shape != tuple(got.shape):
                raise CodecError(
                    f"leaf {i}: shape {tuple(got.shape)} != template {shape}")
            if _template_dtype(ref) != got.dtype:
                raise CodecError(
                    f"leaf {i}: dtype {got.dtype} != template "
                    f"{_template_dtype(ref)}")
    elif snap.treedef is not None:
        treedef = snap.treedef
    else:
        raise CodecError("snapshot has no treedef; pass a template")
    return TR.unflatten(treedef, snap.leaves)


@torch.no_grad()
def copy_into(live: Pytree, saved: Pytree) -> Pytree:
    """Copy ``saved`` (a tree of the same structure, e.g. from
    :func:`snapshot_to_tree`) into the tensors of ``live``, in place.

    The live tensors keep their identity, device and ``requires_grad``; the
    returned tree holds them, with ``live``'s int leaves replaced by
    ``saved``'s.
    """
    dst, treedef = TR.flatten(live)
    src, _ = TR.flatten(saved)
    if len(dst) != len(src):
        raise CodecError(f"copy_into: {len(src)} leaves into {len(dst)}")
    out = []
    for d, s in zip(dst, src):
        if isinstance(d, int):
            out.append(int(s))
        else:
            d.copy_(s)
            out.append(d)
    return TR.unflatten(treedef, out)


def _raw(t: torch.Tensor) -> np.ndarray:
    """A leaf's bytes as a flat uint8 array (a view for contiguous leaves)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def write(snap: Snapshot, f: BinaryIO) -> None:
    """Write ``snap`` to the file object ``f`` in the codec's format, leaf by
    leaf (no second copy of the state in memory)."""
    manifest = {
        "version": _FORMAT_VERSION,
        "shard_id": snap.shard_id,
        "step": snap.step,
        "leaves": [{"dtype": dtype_name(t.dtype), "shape": list(t.shape)}
                   for t in snap.leaves],
        "meta": snap.meta,
    }
    arrays = {f"raw_{i}": _raw(t) for i, t in enumerate(snap.leaves)}
    arrays[MANIFEST_KEY] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), dtype=np.uint8)
    np.savez(f, **arrays)


def read(f: BinaryIO) -> Snapshot:
    """Read a snapshot from the file object ``f`` (treedef is not stored;
    rebuild with a template).  A corrupted file raises :class:`CodecError`;
    an ``OSError`` of the file itself propagates."""
    try:
        data = np.load(f)
    except (ValueError, zipfile.BadZipFile, EOFError) as e:
        raise CodecError(f"unreadable snapshot: {e}") from e
    if not isinstance(data, np.lib.npyio.NpzFile):
        raise CodecError("snapshot is not an .npz archive")
    with data:
        try:
            if MANIFEST_KEY not in data:
                raise CodecError("snapshot has no manifest")
            manifest = json.loads(bytes(data[MANIFEST_KEY]).decode("utf-8"))
            leaves = []
            for i, spec in enumerate(manifest["leaves"]):
                key = f"raw_{i}"
                if key not in data:
                    raise CodecError(f"snapshot is missing leaf {i} "
                                     f"(partial/truncated write?)")
                dtype = _resolve_dtype(spec["dtype"])
                raw = data[key]
                itemsize = torch.empty((), dtype=dtype).element_size()
                want = int(np.prod(spec["shape"])) * itemsize
                if raw.dtype != np.uint8 or raw.nbytes != want:
                    raise CodecError(f"leaf {i}: {raw.nbytes} bytes stored, "
                                     f"expected {want}")
                leaves.append(torch.from_numpy(raw).view(dtype)
                              .reshape(spec["shape"]))
        except (KeyError, ValueError, zipfile.BadZipFile, EOFError) as e:
            raise CodecError(f"corrupted snapshot: {e!r}") from e
    return Snapshot(shard_id=manifest.get("shard_id", "full"),
                    step=int(manifest.get("step", -1)), leaves=leaves,
                    meta=manifest.get("meta", {}))


def encode(snap: Snapshot) -> bytes:
    """Snapshot -> self-describing ``.npz`` bytes (raw leaves + manifest)."""
    buf = io.BytesIO()
    write(snap, buf)
    return buf.getvalue()


def decode(blob: bytes) -> Snapshot:
    """Bytes -> Snapshot (treedef is not stored; rebuild with a template)."""
    try:
        return read(io.BytesIO(blob))
    except OSError as e:
        raise CodecError(f"unreadable snapshot blob: {e}") from e


def tree_nbytes(tree: Pytree) -> int:
    """Serialized size of a tree without copying it."""
    leaves, _ = TR.flatten(tree)
    return int(sum(4 if isinstance(x, int) else x.numel() * x.element_size()
                   for x in leaves))
