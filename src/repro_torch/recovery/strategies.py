"""The paper's recovery policies on :class:`RecoveryStrategy`.

The counterpart of ``repro.recovery.strategies`` for the policies of this
slice:

  checkfree       — Alg. 1 gradient-norm-weighted neighbour merge; edge
                    stages degrade to copy (the paper protects them)
  checkfree_plus  — + swap schedule, so edge stages have trained twins
  redundant       — Bamboo-style redundant computation: exact weights, paid
                    for with a 1.654x iteration time (Table 2)
  none            — ignore failures (convergence lower bound)
  copy / uniform / random — the Fig. 2 ablation reinits

``checkpoint`` and ``elastic`` come later (ROADMAP.md queue 1, items 9-10).
All recovery math lives in ``repro_torch.core.recovery``; it updates the
parameters in place, so each strategy copies the failed stages first to
measure the recovery error.
"""
from __future__ import annotations

from typing import ClassVar, List

import torch

from repro_torch import tree as TR
from repro_torch.core.recovery import (recover_consecutive, recover_stage,
                                       stage_sq_dist)
from repro_torch.core.state import TrainState
from repro_torch.optim.adam import OptState
from repro_torch.recovery.base import FailureContext, RecoveryStrategy
from repro_torch.recovery.registry import register_strategy


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


class MergeRecovery(RecoveryStrategy):
    """Shared CheckFree-family machinery: neighbour-merge reinit of the failed
    stage, zeroed optimizer moments for that stage, Alg. 1's LR boost."""

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
        # host-side metric
        for stage, saved in zip(stages, before):
            err = stage_sq_dist(saved, self.part.get_stage(params, stage))
            event.hist.recovery_errors.append((event.wall_step, err.item()))

    def on_failure(self, state: TrainState,
                   event: FailureContext) -> TrainState:
        k = self.part.num_stages
        reinit = self.reinit
        if not self.handles_edge_stages and event.stage in (0, k - 1):
            # CheckFree (no '+') cannot recover edge stages — the paper
            # protects them; if an event still arrives, degrade to copy.
            reinit = "copy_prev"
        before = TR.clone(self.part.get_stage(state.params, event.stage))
        params = recover_stage(state.params, self.part, event.stage,
                               self._omegas(state), strategy=reinit,
                               generator=event.generator)
        self._recovery_errors([before], params, [event.stage], event)
        opt_state = self._zero_stage_moments(state.opt_state, [event.stage])
        return TrainState(params, opt_state, self._boosted(state.lr_scale),
                          state.omegas, state.effective_step)

    def on_consecutive(self, state: TrainState, run: List[int],
                       event: FailureContext) -> TrainState:
        """Beyond-paper: a run of consecutive stages died together —
        distance-weighted interpolation between the surviving flanks."""
        before = [TR.clone(self.part.get_stage(state.params, s)) for s in run]
        params = recover_consecutive(state.params, self.part, run,
                                     self._omegas(state))
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


@register_strategy("uniform")
class UniformMerge(MergeRecovery):
    reinit = "uniform"


@register_strategy("copy")
class CopyPrev(MergeRecovery):
    reinit = "copy_prev"


@register_strategy("random")
class RandomReinit(MergeRecovery):
    reinit = "random"
