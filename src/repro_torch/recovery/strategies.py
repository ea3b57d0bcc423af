"""The paper's recovery policies on :class:`RecoveryStrategy`.

The counterpart of ``repro.recovery.strategies`` for the policies of this
slice:

  checkfree       — Alg. 1 gradient-norm-weighted neighbour merge; edge
                    stages degrade to copy (the paper protects them)
  checkfree_plus  — + swap schedule, so edge stages have trained twins
  redundant       — Bamboo-style redundant computation: exact weights, paid
                    for with a 1.654x iteration time (Table 2)
  checkpoint      — periodic save / rollback baseline (restarts from a fresh
                    init when a failure precedes the first save)
  elastic         — checkfree, and on a permanent departure a re-cut of
                    the pipeline over the surviving stages (grown back on a
                    regrow)
  none            — ignore failures (convergence lower bound)
  copy / uniform / random — the Fig. 2 ablation reinits

All recovery math
lives in ``repro_torch.core.recovery``; it updates the parameters in place,
so each strategy copies the failed stages first to measure the recovery
error, and a rollback copies the saved state into the live tensors.

On the pipeline backend the CheckFree family is bound to the backend's
in-mesh recovery (``bind_in_mesh``): the reinits of ``IN_MESH_REINITS`` run
as neighbour transfers into the failed rank; ``random`` and runs of
consecutive stages keep the host math, on the tower gathered from every
rank, as in JAX; each recovery error is taken on the failed rank and summed
over the group, so every rank records the same value.  ``checkpoint``
saves each rank's shard there (``ckpt.ShardCheckpointer``) and rolls every
rank back to the one step the group agreed on (``bind_group_reduce``).
"""
from __future__ import annotations

import os
from typing import Any, ClassVar, List, Tuple

import torch

from repro_torch import tree as TR
from repro_torch.core.recovery import (recover_consecutive, recover_stage,
                                       stage_sq_dist)
from repro_torch.core.state import History, TrainState
from repro_torch.optim.adam import OptState
from repro_torch.pipeline.spmd import IN_MESH_REINITS
from repro_torch.recovery.base import FailureContext, RecoveryStrategy
from repro_torch.recovery.registry import register_strategy
from repro_torch.statestore.codec import copy_into
from repro_torch.statestore.store import REPLICATED_DIR, rank_dir


@register_strategy("none")
class NoRecovery(RecoveryStrategy):
    """Failures are ignored — the paper's convergence lower bound."""


@register_strategy("redundant")
class Redundant(RecoveryStrategy):
    """Bamboo: each stage's predecessor holds a redundant copy; on failure it
    promotes the copy, so weights are recovered exactly and only wall-clock
    is charged (every iteration pays the redundant-compute factor)."""

    def iteration_cost(self) -> float:
        return self.wall.iter_time_s * self.wall.redundant_factor

    def failure_cost(self) -> float:
        return self.wall.promote_time_s


@register_strategy("checkpoint")
class Checkpointing(RecoveryStrategy):
    """Periodic full-model save + rollback (the paper's baseline).

    The :class:`~repro_torch.ckpt.Checkpointer` (a single-disk-tier view of
    ``repro_torch.statestore``) is created at first use, so that building
    the strategy stays side-effect-free (cost queries must not wipe
    checkpoint directories).  Wall-clock is priced through the *remote*
    tier spec: the paper's 500 Mb/s link to non-faulty storage (fn. 2).
    A rollback copies the saved parameters, moments and Adam step into the
    live state in place.

    On the pipeline backend each rank saves its shard into
    ``rank<r>/`` of ``checkpoint_dir`` and rank 0 the replicated leaves
    into ``replicated/`` (``ckpt.ShardCheckpointer``).  A rollback is
    global, so every rank takes it: each offers the newest step it can read,
    and every rank restores the least of them, or restarts from the init
    when a rank has no save yet.
    """

    def __init__(self, rcfg, wall):
        super().__init__(rcfg, wall)
        self._ckpt = None

    @property
    def checkpointer(self):
        if self._ckpt is None:
            # deferred import: repro_torch.ckpt sits on top of the state
            # store, whose strategies import the recovery package
            from repro_torch.ckpt.checkpoint import (Checkpointer,
                                                     ShardCheckpointer)
            base, every = self.rcfg.checkpoint_dir, self.rcfg.checkpoint_every
            reduce = self.group_reduce
            self._ckpt = (Checkpointer(base, every) if reduce is None else
                          ShardCheckpointer(
                              rank_dir(base, reduce.rank),
                              os.path.join(base, REPLICATED_DIR), every,
                              writes_replicated=reduce.rank == 0))
        return self._ckpt

    def _shards(self, state: TrainState) -> Tuple[Any, Any]:
        """(this rank's tower slice with its moments, the replicated leaves
        with theirs and Adam's step count): views of the live state."""
        key = self.part.tower_key
        opt = state.opt_state

        def rest(tree):
            return {k: v for k, v in tree.items() if k != key}

        own = {"params": state.params[key], "m": opt.m[key], "v": opt.v[key]}
        replicated = {"params": rest(state.params), "m": rest(opt.m),
                      "v": rest(opt.v), "step": opt.step}
        return own, replicated

    def _restart(self, state: TrainState) -> TrainState:
        """Nothing saved yet -> a fresh init at step 0 (lr_scale resets too:
        any boost belonged to the lost trajectory)."""
        if self.init_fn is None:
            raise RuntimeError("checkpoint strategy needs bind(init_fn=...)")
        params, opt_state = copy_into((state.params, state.opt_state),
                                      self.init_fn())
        return TrainState(params, opt_state, lr_scale=1.0, omegas=None,
                          effective_step=0)

    def on_failure(self, state: TrainState,
                   event: FailureContext) -> TrainState:
        event.hist.recovery_errors.append((event.wall_step, float("nan")))
        if self.group_reduce is not None:
            return self._rollback_group(state)
        ckpt = self.checkpointer
        live = (state.params, state.opt_state)
        if not ckpt.has_checkpoint():
            return self._restart(state)
        step, saved, _lost = ckpt.rollback(state.effective_step, live)
        params, opt_state = copy_into(live, saved)
        return TrainState(params, opt_state, state.lr_scale,
                          state.omegas, effective_step=step)

    def _rollback_group(self, state: TrainState) -> TrainState:
        """The pipeline backend's rollback: the group's least newest
        readable step, restored on every rank (a corrupted newest save on
        one rank sends all of them back to the same earlier one)."""
        ckpt = self.checkpointer
        own, replicated = self._shards(state)
        newest, read = ckpt.newest(own, replicated)
        step = int(self.group_reduce.min(newest))
        if step < 0:
            return self._restart(state)
        own_saved, replicated_saved = ckpt.restore(step, own, replicated,
                                                   read)
        copy_into(own, own_saved)
        opt_step = copy_into(replicated, replicated_saved)["step"]
        opt = state.opt_state
        return TrainState(state.params, OptState(opt.m, opt.v, opt_step),
                          state.lr_scale, state.omegas, effective_step=step)

    def after_step(self, state: TrainState, hist: History) -> None:
        if self.group_reduce is None:
            self.checkpointer.maybe_save(state.effective_step,
                                         (state.params, state.opt_state))
        else:
            self.checkpointer.maybe_save(state.effective_step,
                                         *self._shards(state))

    def after_step_horizon(self, step: int) -> int:
        # saves only fire at multiples of checkpoint_every
        every = max(self.rcfg.checkpoint_every, 1)
        return every - step % every

    def replay_horizon(self) -> int:
        # deepest rollback: the newest checkpoint plus every corrupted-
        # fallback candidate the Checkpointer retains, plus the restart from
        # step 0 before the first save (effective_step < checkpoint_every)
        from repro_torch.ckpt.checkpoint import Checkpointer
        return Checkpointer.DEFAULT_KEEP * max(self.rcfg.checkpoint_every, 1)

    def iteration_cost(self) -> float:
        # saves overlap training partially; amortized residual overhead,
        # priced by the remote tier's latency + bandwidth
        remote = self.wall.tier_specs()["remote"]
        return (self.wall.iter_time_s +
                0.1 * remote.write_time_s(self.wall.model_bytes)
                / self.rcfg.checkpoint_every)

    def failure_cost(self) -> float:
        remote = self.wall.tier_specs()["remote"]
        return (self.wall.restart_overhead_s
                + remote.read_time_s(self.wall.model_bytes))


class MergeRecovery(RecoveryStrategy):
    """Shared CheckFree-family machinery: neighbour-merge reinit of the failed
    stage, zeroed optimizer moments for that stage, Alg. 1's LR boost.

    On the pipeline backend the deterministic reinits run as neighbour
    transfers into the failed rank (``bind_in_mesh``); ``random`` and
    consecutive runs keep the host math on the gathered tower."""

    recover_in_mesh = True
    reinit: ClassVar[str] = "grad_norm"

    def _omegas(self, state: TrainState) -> torch.Tensor:
        if state.omegas is not None:
            return state.omegas
        device = TR.leaves(state.params)[0].device
        return torch.ones((self.part.num_stages,), device=device)

    def _boosted(self, lr_scale: float) -> float:
        return min(lr_scale * self.rcfg.lr_boost,
                   self.rcfg.lr_boost_cap)  # Alg. 1 line 4 (capped)

    @torch.no_grad()
    def _zero_stage_moments(self, opt_state: OptState,
                            stages: List[int]) -> OptState:
        # the failed node's optimizer moments are gone: zero those stages
        for stage in stages:
            for tree in (opt_state.m, opt_state.v):
                for leaf in TR.leaves(self.part.get_stage(tree, stage)):
                    leaf.zero_()
        return opt_state

    def _recovery_errors(self, before, params, stages: List[int],
                         event: FailureContext) -> None:
        # one copy to the host per failed stage: the recovery error is a
        # host-side metric (on the pipeline backend taken on the failed rank,
        # the others' empty slices adding 0)
        for stage, saved in zip(stages, before):
            err = stage_sq_dist(saved, self.part.get_stage(params, stage))
            if self._in_mesh_recover is not None:
                err = self._in_mesh_recover.total(err)
            event.hist.recovery_errors.append((event.wall_step, err.item()))

    def _host_math(self, params, fn):
        """``fn(params, part)``, one of ``core.recovery``'s functions: on the
        pipeline backend over the tower gathered from every rank."""
        if self._in_mesh_recover is None:
            return fn(params, self.part)
        return self._in_mesh_recover.gathered(params, fn)

    def on_failure(self, state: TrainState,
                   event: FailureContext) -> TrainState:
        k = self.part.num_stages
        reinit = self.reinit
        if not self.handles_edge_stages and event.stage in (0, k - 1):
            # CheckFree (no '+') cannot recover edge stages — the paper
            # protects them; if an event still arrives, degrade to copy.
            reinit = "copy_prev"
        before = TR.clone(self.part.get_stage(state.params, event.stage))
        omegas = self._omegas(state)
        if self._in_mesh_recover is not None and reinit in IN_MESH_REINITS:
            params = self._in_mesh_recover(state.params, omegas, event.stage,
                                           reinit)
        else:
            params = self._host_math(state.params, lambda p, part: (
                recover_stage(p, part, event.stage, omegas, strategy=reinit,
                              generator=event.generator)))
        self._recovery_errors([before], params, [event.stage], event)
        opt_state = self._zero_stage_moments(state.opt_state, [event.stage])
        return TrainState(params, opt_state, self._boosted(state.lr_scale),
                          state.omegas, state.effective_step)

    def on_consecutive(self, state: TrainState, run: List[int],
                       event: FailureContext) -> TrainState:
        """Beyond-paper: a run of consecutive stages died together —
        distance-weighted interpolation between the surviving flanks."""
        before = [TR.clone(self.part.get_stage(state.params, s)) for s in run]
        omegas = self._omegas(state)
        params = self._host_math(state.params, lambda p, part: (
            recover_consecutive(p, part, run, omegas)))
        self._recovery_errors(before, params, run, event)
        opt_state = self._zero_stage_moments(state.opt_state, run)
        return TrainState(params, opt_state, self._boosted(state.lr_scale),
                          state.omegas, state.effective_step)

    def failure_cost(self) -> float:
        return self.wall.recovery_time_s


@register_strategy("checkfree")
class CheckFree(MergeRecovery):
    handles_edge_stages = False
    handles_consecutive = True


@register_strategy("checkfree_plus")
class CheckFreePlus(MergeRecovery):
    handles_edge_stages = True
    handles_consecutive = True
    uses_swap_schedule = True


@register_strategy("elastic")
class Elastic(MergeRecovery):
    """CheckFree reconstruction + elastic repartitioning.

    Transient failures behave exactly like ``checkfree``.  When the
    schedule reports a *permanent* departure, the lost stage is first
    rebuilt by the gradient-norm-weighted neighbour merge (the
    ``stage_merge`` kernel on the card) in the old layout; then the trainer
    re-cuts the surviving K-1 stages into balanced contiguous ranges and
    re-captures its fused window; on a later regrow it grows back to K.
    The re-layout is priced once through
    :meth:`repro_torch.core.walltime.WallClockModel.relayout_time_s`.
    """

    handles_edge_stages = False
    handles_consecutive = True
    recover_by_repartition = True


@register_strategy("uniform")
class UniformMerge(MergeRecovery):
    reinit = "uniform"


@register_strategy("copy")
class CopyPrev(MergeRecovery):
    reinit = "copy_prev"


@register_strategy("random")
class RandomReinit(MergeRecovery):
    reinit = "random"
