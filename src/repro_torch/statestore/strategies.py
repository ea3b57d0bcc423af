"""Recovery strategies backed by the tiered state store (the counterpart
of ``repro.statestore.strategies``).

``tiered_ckpt`` (TierCheck-style)
    Every ``hot_every`` iterations each pipeline stage's shard (params +
    Adam moments) is snapshotted into *peer host memory*; every
    ``cold_every`` it also flows asynchronously to local disk, and every
    ``remote_every`` to remote storage.  A stage failure restores **only
    that stage's shard** from the freshest surviving copy — usually the
    hot tier, i.e. bit-identical params at zero lost iterations — instead
    of rolling the whole model back.

``neighbor`` (FFTrainer-style)
    Each stage's shard is replicated into the *next* stage's host memory
    every iteration — no disk traffic on the steady-state path.  A failed
    stage restores from its neighbour's replica; if the replica holder died
    in the same event, the store falls back to the next tier (an optional
    infrequent disk safety net), or to a fresh init of that stage.

Shard ``i`` is placed on host ``(i+1) % K``, so a single node failure never
takes a shard's replica down with its owner; a failure of two adjacent
nodes does, which is the fallback path the colder tiers exist for.

The trainer's state is updated in place: a save copies each stage's slices
to owned host tensors, and a restore copies the served shard into the live
slices.  The recovery error is measured against the stage as it was just
before that copy.  All recovery wall-clock is priced through the tier specs
of the :class:`~repro_torch.core.walltime.WallClockModel`.

On the pipeline backend each rank keeps a store of its own
(``<store_dir>/<name>/rank<r>/``) holding its own stage's shard, under the
host tag ``(r+1) % K`` that the one store of the host backend gives it.
Every rank drops the hosts of every failed stage before any restore, so the
owner's store serves exactly the tier and step that the one store would.
The owner restores, and the group's all-reduce (``bind_group_reduce``)
hands every rank the restored step, the tier, the priced read, the bytes
and the recovery error, so that every rank's history, ``restore_log`` and
wall clock stay equal.  Nothing moves between the ranks: as on the host
backend, the tiers are a simulation priced by the wall-clock model, and a
stage's memory replica on its neighbour's host is a tag, not a transfer.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as TR
from repro_torch.core.recovery import stage_sq_dist
from repro_torch.core.state import History, TrainState
from repro_torch.recovery.base import FailureContext, RecoveryStrategy
from repro_torch.recovery.registry import register_strategy
from repro_torch.statestore.codec import host_snapshot
from repro_torch.statestore.policy import RetentionPolicy
from repro_torch.statestore.store import StateStore, StoreError, rank_dir
from repro_torch.statestore.tiers import DiskTier, MemoryTier, RemoteTier

Pytree = Any


class StoreBackedStrategy(RecoveryStrategy):
    """Shared machinery: sharded snapshots in a tiered store.

    Construction stays side-effect-free (no directories are touched until
    the first save) so pure cost queries can instantiate strategies
    freely; the store is built lazily.
    """

    handles_edge_stages = True     # a real copy exists — edges restore too
    handles_consecutive = True

    #: tier names this strategy builds, fastest first
    tier_names: Tuple[str, ...] = ("mem", "disk", "remote")

    def __init__(self, rcfg, wall):
        super().__init__(rcfg, wall)
        self._store: Optional[StateStore] = None
        self._pending_costs: List[float] = []
        self._pending_nbytes: List[float] = []
        # (wall_step, stage, restored_step, tier) per served restore
        self.restore_log: List[Tuple[int, int, int, str]] = []

    # ---- store construction ------------------------------------------
    @property
    def cold_every(self) -> int:
        return max(self.rcfg.cold_every or self.rcfg.checkpoint_every, 1)

    @property
    def remote_every(self) -> int:
        return max(self.rcfg.remote_every or 10 * self.cold_every, 1)

    @property
    def store(self) -> StateStore:
        if self._store is None:
            self._store = self._build_store()
        return self._store

    def _build_store(self) -> StateStore:
        specs = self.wall.tier_specs()
        base = os.path.join(self.rcfg.store_dir, self.name)
        if self.group_reduce is not None:
            # one store a rank: the others' are theirs to wipe
            base = rank_dir(base, self.group_reduce.rank)
        # a run's snapshots belong to that run: stale tiers from a previous
        # process must not serve restores (as the Checkpointer)
        if os.path.isdir(base):
            shutil.rmtree(base)
        tiers = []
        for name in self.tier_names:
            if name == "mem":
                tiers.append(MemoryTier(specs["mem"]))
            elif name == "disk":
                tiers.append(DiskTier(specs["disk"],
                                      os.path.join(base, "disk")))
            elif name == "remote":
                tiers.append(RemoteTier(specs["remote"],
                                        os.path.join(base, "remote")))
        keep = {"mem": self.rcfg.keep_hot,
                "disk": self.rcfg.keep_cold,
                "remote": self.rcfg.keep_cold}
        return StateStore(tiers, RetentionPolicy(keep=keep))

    # ---- sharding -----------------------------------------------------
    @staticmethod
    def _shard_id(stage: int) -> str:
        return f"stage{stage:02d}"

    def _shard_host(self, stage: int) -> int:
        return (stage + 1) % self.part.num_stages

    def _shard_tree(self, state: TrainState, stage: int) -> Dict[str, Pytree]:
        """One stage's recoverable state (views of the live slices): params
        slice + Adam moments."""
        return {"params": self.part.get_stage(state.params, stage),
                "m": self.part.get_stage(state.opt_state.m, stage),
                "v": self.part.get_stage(state.opt_state.v, stage)}

    @torch.no_grad()
    def _set_shard(self, state: TrainState, stage: int,
                   shard: Dict[str, Pytree]) -> float:
        """Copy ``shard`` into stage ``stage``'s live slices; returns the
        recovery error ||restored - lost||^2 of its params, measured before
        the copy overwrites the lost values."""
        live = self.part.get_stage(state.params, stage)
        device = TR.leaves(live)[0].device
        params = TR.map(lambda t: t.to(device), shard["params"])
        err = stage_sq_dist(live, params).item()
        self.part.set_stage(state.params, stage, params)
        self.part.set_stage(state.opt_state.m, stage, shard["m"])
        self.part.set_stage(state.opt_state.v, stage, shard["v"])
        return err

    def _save_shards(self, state: TrainState, tiers: List[str]) -> None:
        """One host copy per shard this process holds (on the pipeline
        backend the rank's own), placed into every tier in ``tiers``."""
        if not tiers:
            return
        reduce = self.group_reduce
        stages = (range(self.part.num_stages) if reduce is None
                  else [reduce.rank])
        for stage in stages:
            snap = host_snapshot(self._shard_tree(state, stage),
                                 step=state.effective_step,
                                 shard_id=self._shard_id(stage))
            for tier in tiers:
                self.store.put(None, step=snap.step, shard_id=snap.shard_id,
                               tier=tier, host=self._shard_host(stage),
                               snap=snap)

    # ---- restore ------------------------------------------------------
    #: a restore's tier as a number, for the group's all-reduce
    TIERS = ("init", "mem", "disk", "remote")

    def _restore_stage(self, state: TrainState, stage: int,
                       event: FailureContext) -> TrainState:
        """Restore one stage's shard from the freshest surviving tier,
        recording the tier-priced cost for the trainer's clock; on the
        pipeline backend the owner restores and every rank records what
        it shares."""
        reduce = self.group_reduce
        row = None
        if reduce is None or reduce.rank == stage:
            row = self._restore_own(state, stage)
        if reduce is not None:
            row = reduce.share(row, stage, 5)
        step, tier, cost, nbytes, err = row
        self._pending_costs.append(cost)
        self._pending_nbytes.append(nbytes)
        self.restore_log.append((event.wall_step, stage, int(step),
                                 self.TIERS[int(tier)]))
        event.hist.recovery_errors.append((event.wall_step, err))
        return state

    def _restore_own(self, state: TrainState, stage: int) -> List[float]:
        """Restore a stage this process holds -> (step, tier number, priced
        read seconds, bytes, recovery error)."""
        template = self._shard_tree(state, stage)
        try:
            res = self.store.restore(self._shard_id(stage), template)
        except StoreError:
            # nothing stored anywhere (failure before the first snapshot):
            # reinit this stage from a fresh seed — still no global rollback
            if self.init_fn is None:
                raise RuntimeError(f"{self.name} needs bind(init_fn=...)") \
                    from None
            params, opt_state = self.init_fn()
            shard = self._shard_tree(TrainState(params, opt_state), stage)
            err = self._set_shard(state, stage, shard)
            return [-1, 0, self.wall.restart_overhead_s,
                    self.wall.stage_bytes(self.part.num_stages), err]
        err = self._set_shard(state, stage, res.tree)
        return [res.step, self.TIERS.index(res.tier), res.read_time_s,
                float(res.nbytes), err]

    # ---- lifecycle ----------------------------------------------------
    def on_failure(self, state: TrainState,
                   event: FailureContext) -> TrainState:
        self.store.drop_host(event.stage)   # the dead node's memory is gone
        return self._restore_stage(state, event.stage, event)

    def on_consecutive(self, state: TrainState, run: List[int],
                       event: FailureContext) -> TrainState:
        # every dead node's memory vanishes *before* any restore is
        # attempted — a replica hosted on another member of the run must
        # not serve (the correlated-failure case the colder tiers exist for)
        for stage in run:
            self.store.drop_host(stage)
        for stage in run:
            state = self._restore_stage(
                state, stage, dataclasses.replace(event, stage=stage))
        return state

    def on_layout_change(self, state: TrainState, old, new) -> TrainState:
        """The trainer re-cut the stage layout: every stored shard is sliced
        along stale bounds and must not serve a restore.  Rebind the
        partition, then re-shard: drop every snapshot and seed the fastest
        tier synchronously with shards cut from the current state along the
        new bounds (placed by the new ``(i+1) % K`` rule)."""
        self.part = new
        if self._store is not None:
            shards = {}
            hosts = {}
            for stage in range(new.num_stages):
                sid = self._shard_id(stage)
                shards[sid] = self._shard_tree(state, stage)
                hosts[sid] = self._shard_host(stage)
            self._store.reshard(shards, step=state.effective_step,
                                hosts=hosts)
        return state

    def on_run_end(self) -> None:
        if self._store is not None:
            self._store.close()

    # ---- wall-clock ---------------------------------------------------
    def failure_cost(self) -> float:
        if self._pending_costs:
            return self._pending_costs.pop(0)
        # side-effect-free estimate: a hot-tier read of one stage shard
        return self.wall.tier_specs()["mem"].read_time_s(
            self.wall.stage_bytes(self.rcfg.num_stages))

    def consume_restore_bytes(self) -> Optional[float]:
        if self._pending_nbytes:
            return self._pending_nbytes.pop(0)
        return None

    def _amortized_write_s(self, tier_name: str, every: int) -> float:
        """Per-iteration residual of an asynchronous full-model write to
        ``tier_name`` every ``every`` iterations: 10% of it, as the classic
        checkpoint baseline charges."""
        spec = self.wall.tier_specs()[tier_name]
        return 0.1 * spec.write_time_s(self.wall.model_bytes) / max(every, 1)


@register_strategy("tiered_ckpt")
class TieredCheckpoint(StoreBackedStrategy):
    """TierCheck-style tiered checkpointing (memory -> disk -> remote)."""

    tier_names = ("mem", "disk", "remote")

    def after_step(self, state: TrainState, hist: History) -> None:
        step = state.effective_step
        tiers = []
        if step % max(self.rcfg.hot_every, 1) == 0:
            tiers.append("mem")
        if step % self.cold_every == 0:
            tiers.append("disk")
        if step % self.remote_every == 0:
            tiers.append("remote")
        self._save_shards(state, tiers)

    def after_step_horizon(self, step: int) -> int:
        # snapshots only fire when a tier's cadence divides the step
        cadences = (max(self.rcfg.hot_every, 1), self.cold_every,
                    self.remote_every)
        return min(c - step % c for c in cadences)

    def iteration_cost(self) -> float:
        # the hot snapshot's host copy is on the critical path; disk and
        # remote writes are asynchronous residuals
        specs = self.wall.tier_specs()
        hot = (specs["mem"].write_time_s(self.wall.model_bytes)
               / max(self.rcfg.hot_every, 1))
        return (self.wall.iter_time_s + hot
                + self._amortized_write_s("disk", self.cold_every)
                + self._amortized_write_s("remote", self.remote_every))


@register_strategy("neighbor")
class NeighborReplication(StoreBackedStrategy):
    """FFTrainer-style in-memory neighbour replication.

    Steady state touches no disk: replicas live purely in peer host
    memory.  ``rcfg.neighbor_cold`` (default on) adds an infrequent
    asynchronous disk copy so a correlated failure of a shard's owner
    *and* its replica holder still has a tier to fall back to.
    """

    @property
    def tier_names(self) -> Tuple[str, ...]:  # type: ignore[override]
        return ("mem", "disk") if self.rcfg.neighbor_cold else ("mem",)

    def after_step(self, state: TrainState, hist: History) -> None:
        tiers = ["mem"]
        if self.rcfg.neighbor_cold and \
                state.effective_step % self.cold_every == 0:
            tiers.append("disk")
        self._save_shards(state, tiers)

    def after_step_horizon(self, step: int) -> int:
        return 1    # a fresh replica lands in peer memory every iteration

    def iteration_cost(self) -> float:
        specs = self.wall.tier_specs()
        cost = (self.wall.iter_time_s
                + specs["mem"].write_time_s(self.wall.model_bytes))
        if self.rcfg.neighbor_cold:
            cost += self._amortized_write_s("disk", self.cold_every)
        return cost
