"""Disk checkpointing over the state store (the counterpart of
``repro.ckpt.checkpoint``).

The same ``ckpt_<step>.npz`` directory layout and the same module API
(``save_checkpoint`` / ``load_checkpoint`` / ``latest_step`` /
:class:`Checkpointer`), written through the state store's disk tier and
codec, so either package loads the other's checkpoints (bf16 leaves
bit-exactly).  Failures raise :class:`CheckpointError` (not ``assert``,
which vanishes under ``python -O``), stale ``*.tmp`` leftovers from
interrupted saves are swept on startup, and a corrupted newest checkpoint
falls back to the previous intact one.

Checkpoints of the older format (typed ``leaf_<i>`` arrays, no manifest)
still load — including bf16 leaves that format stored as ``|V2`` void
records, recovered by reinterpreting their bytes through the template's
dtype.

Loads return trees of host tensors; the checkpoint strategy copies them
into the live training state.  On the pipeline backend each rank saves and
restores its shard through a :class:`ShardCheckpointer`.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.core.walltime import TierSpec
from repro_torch.statestore import codec
from repro_torch.statestore.codec import (DTYPES, CodecError, dtype_name,
                                          host_snapshot, snapshot_to_tree)
from repro_torch.statestore.policy import RetentionPolicy
from repro_torch.statestore.store import StateStore, StoreError
from repro_torch.statestore.tiers import DiskTier

Pytree = Any

_CKPT_TEMPLATE = "ckpt_{step:08d}.npz"
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")

# the checkpointer prices nothing (the strategy charges checkpoints through
# WallClockModel's tier specs); this spec only parameterizes the container
_SPEC = TierSpec("disk", "disk", capacity_bytes=float("inf"),
                 latency_s=0.0, bandwidth_Bps=float("inf"))


class CheckpointError(RuntimeError):
    """A checkpoint is missing, corrupted, or does not match its template."""


def _tier(directory: str) -> DiskTier:
    return DiskTier(_SPEC, directory, template=_CKPT_TEMPLATE)


def clean_stale_tmp(directory: str) -> List[str]:
    """Remove leftover temp files from interrupted saves (both the current
    ``*.npz.tmp`` and the legacy ``*.npz.tmp.npz`` convention); returns the
    removed filenames.  The disk tier also does this on startup."""
    return _tier(directory).cleaned_on_init


def save_checkpoint(directory: str, step: int, tree: Pytree) -> str:
    """Write ``tree`` to ``directory/ckpt_<step>.npz`` (atomic rename)."""
    _tier(directory).put(host_snapshot(tree, step=step, shard_id="full"))
    return os.path.join(directory, _CKPT_TEMPLATE.format(step=step))


def _load_legacy(path: str, template: Pytree) -> Pytree:
    """The older format: typed ``leaf_<i>`` arrays, no manifest."""
    try:
        data = np.load(path)
    except Exception as e:  # noqa: BLE001 — any unreadable file
        raise CheckpointError(f"unreadable checkpoint {path}: {e}") from e
    refs, treedef = TR.flatten(template)
    loaded = []
    with data:
        for i, ref in enumerate(refs):
            key = f"leaf_{i}"
            if key not in data:
                raise CheckpointError(
                    f"{path} is missing leaf {i} (partial/truncated save?)")
            got = np.asarray(data[key])
            shape = () if isinstance(ref, int) else tuple(ref.shape)
            if shape != got.shape:
                raise CheckpointError(
                    f"{path} leaf {i}: shape {got.shape} != template {shape}")
            want = torch.int32 if isinstance(ref, int) else ref.dtype
            itemsize = torch.empty((), dtype=want).element_size()
            if got.dtype.kind == "V" and got.dtype.itemsize == itemsize:
                # extended dtypes (bf16) were stored as raw void records;
                # the bytes are intact — reinterpret them
                got = np.frombuffer(got.tobytes(), np.uint8)
            elif DTYPES.get(got.dtype.name) == want:
                got = np.frombuffer(np.ascontiguousarray(got).tobytes(),
                                    np.uint8)
            else:
                raise CheckpointError(
                    f"{path} leaf {i}: dtype {got.dtype} != template "
                    f"{dtype_name(want)}")
            loaded.append(torch.from_numpy(got.copy()).view(want)
                          .reshape(shape))
    return TR.unflatten(treedef, loaded)


def load_checkpoint(directory: str, template: Pytree,
                    step: Optional[int] = None) -> Tuple[int, Pytree]:
    """Load the checkpoint at ``step`` (default: latest) into the structure
    of ``template`` (host tensors); raises :class:`CheckpointError` on a
    missing, corrupted, or mismatched checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(f"no checkpoints in {directory}")
    path = os.path.join(directory, _CKPT_TEMPLATE.format(step=step))
    if not os.path.exists(path):
        raise CheckpointError(f"no checkpoint at step {step} in {directory}")
    try:
        with open(path, "rb") as f:
            return step, snapshot_to_tree(codec.read(f), template)
    except CodecError as codec_err:
        try:
            return step, _load_legacy(path, template)
        except CheckpointError as legacy_err:
            raise CheckpointError(
                f"checkpoint {path} failed to load (codec: {codec_err}; "
                f"legacy: {legacy_err})") from legacy_err


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _CKPT_RE.match(f))]
    return max(steps) if steps else None


class Checkpointer:
    """Periodic checkpoint + rollback protocol (the paper's baseline),
    backed by a single-disk-tier :class:`~repro_torch.statestore.StateStore`.

    ``maybe_save`` is called every iteration; ``rollback`` returns the last
    saved state and the number of lost iterations.  Saves stay synchronous
    (the asynchronous path belongs to ``tiered_ckpt``): this class *is* the
    strawman being compared against.  Construction wipes ``directory``
    unless ``wipe`` is False (a reader of another process's checkpoints).
    """

    SHARD = "full"
    DEFAULT_KEEP = 3

    def __init__(self, directory: str, every: int, keep: int = DEFAULT_KEEP,
                 *, wipe: bool = True):
        self.dir = directory
        self.every = max(every, 1)
        self.keep = keep
        if wipe and os.path.isdir(directory):
            shutil.rmtree(directory)
        os.makedirs(directory, exist_ok=True)
        self.store = StateStore(
            [_tier(directory)],
            RetentionPolicy(keep={"disk": keep}))

    def maybe_save(self, step: int, tree: Pytree) -> bool:
        if step % self.every != 0:
            return False
        self.store.put(tree, step=step, shard_id=self.SHARD, tier="disk",
                       sync=True)
        return True

    def has_checkpoint(self) -> bool:
        """True once at least one save landed (rollback will not raise)."""
        return self.store.latest_step(self.SHARD) is not None

    def rollback(self, current_step: int, template: Pytree,
                 max_step: Optional[int] = None) -> Tuple[int, Pytree, int]:
        """Returns (ckpt_step, tree of host tensors, lost_iterations) of the
        newest intact checkpoint (at or below ``max_step`` when given): a
        corrupted newest checkpoint falls back to the previous intact one."""
        try:
            res = self.store.restore(self.SHARD, template, max_step=max_step)
        except StoreError as e:
            raise CheckpointError(f"no checkpoint to roll back to: {e}") \
                from e
        return res.step, res.tree, current_step - res.step


class ShardCheckpointer:
    """The checkpoints of one rank of the pipeline backend: the rank's own
    shard (its slice of the tower with that slice's Adam moments) in
    ``own_dir``, which this rank alone wipes, and the replicated leaves (the
    embedding, final norm, head and ``pos_embed``, their moments and Adam's
    step count) in ``replicated_dir``, written once, by the rank that
    ``writes_replicated``.  A save so holds each byte of the model once.
    Every rank reads the replicated shard from there on a rollback: the
    checkpoints stand for storage that every node reaches (the paper's
    remote tier), as one directory does on one machine.

    The rollback is the group's (``Checkpointing`` on the pipeline
    backend): each rank offers :meth:`newest`, the group takes the least,
    and every rank restores that step (:meth:`restore`) or raises.
    """

    def __init__(self, own_dir: str, replicated_dir: str, every: int, *,
                 writes_replicated: bool,
                 keep: int = Checkpointer.DEFAULT_KEEP):
        self.own = Checkpointer(own_dir, every, keep)
        self.replicated_dir = replicated_dir
        self.replicated = (Checkpointer(replicated_dir, every, keep)
                           if writes_replicated else None)

    def maybe_save(self, step: int, own: Pytree, replicated: Pytree) -> bool:
        if not self.own.maybe_save(step, own):
            return False
        if self.replicated is not None:
            self.replicated.maybe_save(step, replicated)
        return True

    def newest(self, own: Pytree, replicated: Pytree
               ) -> Tuple[int, Dict[str, Tuple[int, Pytree]]]:
        """The newest step this rank can read, -1 before its first save:
        its own shard's newest intact save, and on the rank that writes the
        replicated shard the older of that and the replicated shard's; with
        the trees read, by shard, for :meth:`restore` to reuse.  Raises
        :class:`CheckpointError` when saves exist and none is intact."""
        if not self.own.has_checkpoint():
            return -1, {}
        step, tree, _ = self.own.rollback(0, own)
        read = {"own": (step, tree)}
        if self.replicated is not None:
            rstep, rtree, _ = self.replicated.rollback(0, replicated)
            read["replicated"] = (rstep, rtree)
            step = min(step, rstep)
        return step, read

    def restore(self, step: int, own: Pytree, replicated: Pytree,
                read: Dict[str, Tuple[int, Pytree]]) -> Tuple[Pytree, Pytree]:
        """Both shards at exactly ``step`` (the group's), as trees of host
        tensors: from ``read`` where :meth:`newest` read that step, else
        from the files.  Raises :class:`CheckpointError` when a shard has
        no intact save at ``step``."""
        def at(name: str, ckpt: Checkpointer, template: Pytree) -> Pytree:
            got = read.get(name)
            if got is None or got[0] != step:
                got = ckpt.rollback(step, template, max_step=step)[:2]
            if got[0] != step:
                raise CheckpointError(
                    f"{name} shard in {ckpt.dir}: no intact checkpoint at "
                    f"the group's step {step} (newest below it: {got[0]})")
            return got[1]

        # the replicated shard of the rank that writes it, or a reader of
        # its files that wipes nothing
        reader = self.replicated or Checkpointer(
            self.replicated_dir, self.own.every, self.own.keep, wipe=False)
        return (at("own", self.own, own),
                at("replicated", reader, replicated))
