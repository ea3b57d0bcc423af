"""The tiered state store (the counterpart of ``repro.statestore.store``).

A :class:`StateStore` owns an ordered list of tiers (fastest first) and
mediates every save/restore:

* **save** — one synchronous host copy per shard, then per-tier placement:
  memory puts land inline (a reference store), disk/remote writes run on
  the :class:`~repro_torch.statestore.snapshot.AsyncSnapshotter` so the
  train step never blocks on a serialize;
* **restore** — the *freshest* step available for the shard wins (lost
  work dominates read cost by orders of magnitude), served from the
  fastest tier holding it; corrupted snapshots are skipped in favour of
  the next copy instead of failing the restore;
* **retention** — after every put the policy trims that tier's history;
* **failure semantics** — ``drop_host(stage)`` wipes a dead node's
  in-memory replicas before a restore is attempted;
* **re-layout** — ``reshard`` drops every snapshot cut along the old stage
  bounds and seeds the fastest tier with shards cut along the new ones.

On the pipeline backend every rank keeps its checkpoints and stores in
directories of its own under the ones the stage group shares
(:func:`rank_dirs`), since each wipes its directory when it starts.

Every restore returns the serving tier and its priced read time, which is
how recovery strategies charge tier-real wall-clock.  The restored tree
holds host tensors (a memory tier's own); the caller copies them into the
live state (:func:`~repro_torch.statestore.codec.copy_into`) and never
trains on them.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch import telemetry
from repro_torch.statestore.codec import (CodecError, Pytree, Snapshot,
                                          host_snapshot, snapshot_to_tree)
from repro_torch.statestore.policy import RetentionPolicy
from repro_torch.statestore.snapshot import AsyncSnapshotter
from repro_torch.statestore.tiers import StorageTier, TierError


#: under a directory the stage group shares, the directory of the shard every
#: rank reads on the pipeline backend (the replicated leaves), written by
#: rank 0 alone
REPLICATED_DIR = "replicated"


def rank_dirs(rank: int) -> List[str]:
    """The directories that rank ``rank`` of the pipeline backend writes,
    and alone wipes, under a directory the stage group shares: its own
    (``rank<r>``), and on rank 0 also :data:`REPLICATED_DIR`."""
    return [f"rank{rank:02d}"] + ([REPLICATED_DIR] if rank == 0 else [])


def rank_dir(directory: str, rank: int) -> str:
    """Rank ``rank``'s own directory under ``directory``."""
    return os.path.join(directory, rank_dirs(rank)[0])


class StoreError(RuntimeError):
    """No tier could serve a requested restore."""


@dataclass
class RestoreResult:
    """What a restore produced and what it cost."""

    step: int                # step of the snapshot served
    tree: Pytree
    tier: str                # serving tier name
    nbytes: int              # serialized size actually read
    read_time_s: float       # priced by the serving tier's spec


class StateStore:
    """Tiered snapshot storage with asynchronous cold writes."""

    def __init__(self, tiers: List[StorageTier],
                 retention: Optional[RetentionPolicy] = None,
                 snapshot_depth: int = 2):
        if not tiers:
            raise ValueError("StateStore needs at least one tier")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        self.tiers = list(tiers)          # fastest first
        self.retention = retention or RetentionPolicy()
        # at most snapshot_depth asynchronous writes in flight
        self.writer = AsyncSnapshotter(depth=snapshot_depth)

    def tier(self, name: str) -> StorageTier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier {name!r}; have {[t.name for t in self.tiers]}")

    # ---- save ---------------------------------------------------------
    def put(self, tree: Pytree, *, step: int, shard_id: str,
            tier: str, host: Optional[int] = None,
            sync: bool = False, snap: Optional[Snapshot] = None) -> Snapshot:
        """Snapshot ``tree`` into ``tier``.

        The host copy is always synchronous; the tier write is inline for
        memory tiers (reference store) and asynchronous otherwise unless
        ``sync``.  Pass ``snap`` to reuse one host copy across several
        tier placements of the same state.
        """
        t = self.tier(tier)
        if snap is None:
            snap = host_snapshot(tree, step=step, shard_id=shard_id)
        if t.kind == "memory" or sync:
            t.put(snap, host=host)
            self.retention.apply(t, shard_id)
            telemetry.emit("snapshot_save", step=step, shard_id=shard_id,
                           tier=t.name, nbytes=snap.nbytes,
                           synchronous=True)
        else:
            def write(t=t, snap=snap, shard_id=shard_id, step=step):
                # runs on the AsyncSnapshotter thread; the span lands on
                # its own row of the Chrome trace
                with telemetry.span("tier_write", cat="statestore",
                                    tier=t.name, shard_id=shard_id,
                                    nbytes=snap.nbytes):
                    t.put(snap, host=host)
                    self.retention.apply(t, shard_id)
                telemetry.emit("snapshot_save", step=step,
                               shard_id=shard_id, tier=t.name,
                               nbytes=snap.nbytes, synchronous=False)
            self.writer.submit(write)
        return snap

    def flush(self) -> None:
        """Block until every asynchronous write has landed."""
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()

    # ---- query --------------------------------------------------------
    def latest_step(self, shard_id: str) -> Optional[int]:
        best = None
        for t in self.tiers:
            steps = t.steps(shard_id)
            if steps and (best is None or steps[-1] > best):
                best = steps[-1]
        return best

    def drop_host(self, host: int) -> int:
        """A node died: wipe its in-memory replicas across all tiers."""
        return sum(t.drop_host(host) for t in self.tiers)

    # ---- elastic re-layout --------------------------------------------
    def reshard(self, shards: Dict[str, Pytree], *, step: int,
                hosts: Dict[str, int]) -> None:
        """A stage-layout change made every stored snapshot stale.

        Shards are cut along stage bounds, so after an elastic shrink or
        grow the stored copies describe ranges that no longer exist: a
        restore from them would graft the wrong layers.  Drop everything
        (every shard, every tier), then seed the fastest tier synchronously
        with the freshly cut ``shards`` (``{shard_id: tree}``) at ``step``;
        ``hosts`` maps each shard id to its new host.  Colder tiers refill
        at their usual cadence from the strategy's ``after_step``.
        """
        self.flush()
        for t in self.tiers:
            for sid in t.shard_ids():
                for s in list(t.steps(sid)):
                    t.delete(sid, s)
        for sid, tree in shards.items():
            self.put(tree, step=step, shard_id=sid, tier=self.tiers[0].name,
                     host=hosts[sid], sync=True)

    # ---- restore ------------------------------------------------------
    def restore(self, shard_id: str, template: Optional[Pytree] = None, *,
                max_step: Optional[int] = None) -> RestoreResult:
        """Serve the freshest copy of ``shard_id`` (at or below ``max_step``
        when given) from the fastest tier holding it.

        Pending asynchronous writes are flushed first so a restore can
        never race its own in-flight checkpoint.  A corrupted snapshot is
        skipped (with a warning) and the next-freshest copy is tried.  The
        restore is a ``restore`` span and a ``snapshot_restore`` event.
        """
        with telemetry.span("restore", cat="statestore",
                            shard_id=shard_id):
            res = self._restore(shard_id, template, max_step)
        telemetry.emit("snapshot_restore", step=res.step,
                       shard_id=shard_id, tier=res.tier, nbytes=res.nbytes,
                       read_time_s=res.read_time_s)
        return res

    def _restore(self, shard_id: str, template: Optional[Pytree],
                 max_step: Optional[int]) -> RestoreResult:
        self.flush()
        # candidate (step, tier) pairs: freshest step first; ties broken by
        # tier order (fastest first)
        candidates = []
        for rank, t in enumerate(self.tiers):
            for s in t.steps(shard_id):
                if max_step is None or s <= max_step:
                    candidates.append((-s, rank, t))
        if not candidates:
            raise StoreError(f"no snapshot of {shard_id!r} in any tier")
        candidates.sort(key=lambda c: (c[0], c[1]))
        last_err: Optional[Exception] = None
        for neg_s, _, t in candidates:
            step = -neg_s
            try:
                snap = t.get(shard_id, step)
                tree = snapshot_to_tree(snap, template)
            except (TierError, CodecError) as e:
                warnings.warn(
                    f"statestore: skipping {shard_id}@{step} on tier "
                    f"{t.name!r}: {e}", RuntimeWarning, stacklevel=2)
                last_err = e
                continue
            return RestoreResult(step=step, tree=tree, tier=t.name,
                                 nbytes=snap.nbytes,
                                 read_time_s=t.read_time_s(snap.nbytes))
        raise StoreError(
            f"every snapshot of {shard_id!r} failed to decode "
            f"(last error: {last_err})")

    def __repr__(self) -> str:
        return f"StateStore(tiers={[t.name for t in self.tiers]})"
