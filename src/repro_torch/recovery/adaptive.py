"""Adaptive recovery — runtime policy switching (the Chameleon idea,
arXiv 2508.21613); the counterpart of ``repro.recovery.adaptive``.

Wraps two child strategies from the registry: a cheap optimistic policy for
calm periods (default CheckFree) and a conservative one for stormy periods
(default checkpointing).  A sliding window over the last
``adaptive_window`` wall iterations tracks the empirical failure rate
(failures per iteration); when it crosses ``adaptive_threshold`` the active
policy switches to ``adaptive_high``, and back once the window drains.
When the schedule reports an observed failure rate
(:meth:`observe_environment`), that rate takes precedence over the window.

The high child's ``after_step`` bookkeeping runs even while the low policy
is active ("shadow checkpointing"), so a switch under fire has warm state
to roll back to; the wall-clock model only charges the active child's
iteration cost.

Per permanent departure the policy also decides whether to shrink the
pipeline (:meth:`Adaptive.accept_repartition`): the one-time re-layout
against staying degraded on a spare, logged in ``repartition_decisions``.
As in JAX it advertises ``recover_by_repartition`` on every instance, so the
trainer asks it at each departure whatever its children are.

On the pipeline backend it also advertises ``recover_in_mesh`` when a child
does, and passes the backend's in-mesh recovery and the group's all-reduce
through to its children: a ``checkfree`` child then merges by neighbour
transfers into the failed rank, where host math on the rank's shard would
find no neighbours, and a ``checkpoint`` child rolls every rank back to one
step.  JAX needs no such delegation, since its arrays are global.  The
switch itself needs no reduction: it rests on the failure counts and the
schedule's observed rate, the same on every rank.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Tuple

from repro_torch.core.state import History, TrainState
from repro_torch.recovery.base import FailureContext, RecoveryStrategy
from repro_torch.recovery.registry import make_strategy, register_strategy

@register_strategy("adaptive")
class Adaptive(RecoveryStrategy):

    def __init__(self, rcfg, wall):
        super().__init__(rcfg, wall)
        low, high = rcfg.adaptive_low, rcfg.adaptive_high
        if "adaptive" in (low, high):
            raise ValueError("adaptive children must be concrete strategies")
        self.low = make_strategy(
            dataclasses.replace(rcfg, strategy=low), wall=wall)
        # same policy both sides -> one shared instance, so the after_step
        # guard below really does prevent double bookkeeping
        self.high = self.low if high == low else make_strategy(
            dataclasses.replace(rcfg, strategy=high), wall=wall)
        self.active = self.low
        self._window = deque(maxlen=max(rcfg.adaptive_window, 1))
        self._pending = 0          # failures since the last wall iteration
        self._env_rate = None      # the schedule's observed rate
        # (effective_step, from, to) switch log
        self.switches: List[Tuple[int, str, str]] = []
        # (wall_step, accepted, relayout_s, stay_degraded_s) per departure
        self.repartition_decisions: List[Tuple[int, bool, float, float]] = []

    # ---- capability flags follow the children -------------------------
    # On instances these delegate dynamically; on the class itself they
    # report the conservative default (registry tooling inspects classes).
    class _ChildFlag:
        def __init__(self, getter, class_default: bool):
            self._getter = getter
            self._default = class_default

        def __get__(self, obj, objtype=None) -> bool:
            return self._default if obj is None else self._getter(obj)

    handles_edge_stages = _ChildFlag(
        lambda self: self.active.handles_edge_stages, False)
    handles_consecutive = _ChildFlag(
        lambda self: self.active.handles_consecutive, False)
    # swap is static: the train step is built once, before any switching
    uses_swap_schedule = _ChildFlag(
        lambda self: (self.low.uses_swap_schedule or
                      self.high.uses_swap_schedule), False)
    # the policy itself decides per departure whether to shrink
    # (accept_repartition prices the re-layout against staying degraded),
    # so an instance always advertises the capability, as JAX's does
    recover_by_repartition = _ChildFlag(lambda self: True, False)
    # the pipeline backend's neighbour transfers, for a child that takes them
    recover_in_mesh = _ChildFlag(
        lambda self: (self.low.recover_in_mesh or
                      self.high.recover_in_mesh), False)

    # ---- wiring -------------------------------------------------------
    def _children(self) -> List[RecoveryStrategy]:
        """The distinct children (one when both sides are one policy)."""
        return [self.low] if self.high is self.low else [self.low, self.high]

    def bind(self, part, init_fn=None) -> "Adaptive":
        super().bind(part, init_fn)
        for child in self._children():
            child.bind(part, init_fn)
        return self

    def bind_in_mesh(self, recover_fn) -> "Adaptive":
        super().bind_in_mesh(recover_fn)
        for child in self._children():
            if child.recover_in_mesh:
                child.bind_in_mesh(recover_fn)
        return self

    def bind_group_reduce(self, reduce) -> "Adaptive":
        super().bind_group_reduce(reduce)
        for child in self._children():
            child.bind_group_reduce(reduce)
        return self

    # ---- lifecycle ----------------------------------------------------
    def observe_environment(self, rate: float) -> None:
        """The schedule's observed failure rate supersedes the strategy's
        own sliding window while it flows."""
        self._env_rate = float(rate)

    def failure_rate(self) -> float:
        """Failures per wall iteration: the observed rate when the schedule
        provides one, else the local sliding window."""
        if self._env_rate is not None:
            return self._env_rate
        if not self._window:
            return 0.0
        return sum(self._window) / len(self._window)

    def on_failure(self, state: TrainState,
                   event: FailureContext) -> TrainState:
        self._pending += 1
        return self.active.on_failure(state, event)

    def on_consecutive(self, state: TrainState, run: List[int],
                       event: FailureContext) -> TrainState:
        self._pending += len(run)
        return self.active.on_consecutive(state, run, event)

    # ---- elastic repartitioning ---------------------------------------
    #: pipeline slowdown while a departed slot limps on a spare (the
    #: simulator's default ``spare_penalty``)
    DEGRADED_PENALTY = 1.5

    def on_departure(self, state: TrainState,
                     event: FailureContext) -> TrainState:
        self._pending += 1
        return self.active.on_departure(state, event)

    def accept_repartition(self, event: FailureContext,
                           moved_bytes: float) -> bool:
        """Shrink only when the one-time re-layout beats staying degraded.

        * re-layout: ``relayout_time_s(moved_bytes)`` once;
        * stay at K: an in-place restore (a memory-tier read of one stage
          shard) plus the spare's excess iteration time over the expected
          degraded horizon, which observed churn shortens (a stormy cluster
          returns capacity soon; a calm one makes the loss permanent).
        """
        relayout_s = self.wall.relayout_time_s(moved_bytes)
        specs = self.wall.tier_specs()
        restore_s = specs["mem"].read_time_s(
            self.wall.stage_bytes(self.part.num_stages))
        window = max(self.rcfg.adaptive_window, 1)
        expected_fails = self.failure_rate() * window
        horizon_iters = window / max(expected_fails, 1.0)
        degraded_s = ((self.DEGRADED_PENALTY - 1.0)
                      * self.wall.iter_time_s * horizon_iters)
        accept = relayout_s <= restore_s + degraded_s
        self.repartition_decisions.append(
            (event.wall_step, accept, relayout_s, restore_s + degraded_s))
        return accept

    def on_layout_change(self, state: TrainState, old, new) -> TrainState:
        self.part = new
        for child in self._children():
            state = child.on_layout_change(state, old, new)
        return state

    def after_step(self, state: TrainState, hist: History) -> None:
        self._window.append(self._pending)
        self._pending = 0
        want = (self.high if self.failure_rate() > self.rcfg.adaptive_threshold
                else self.low)
        if want is not self.active:
            self.switches.append((state.effective_step,
                                  self.active.name, want.name))
            self.active = want
        for child in self._children():
            child.after_step(state, hist)

    def after_step_horizon(self, step: int) -> int:
        # the sliding window takes one sample per wall iteration (and the
        # children's shadow bookkeeping runs per step): always eager
        return 1

    def replay_horizon(self):
        # either child may be active when a failure lands; the batch cache
        # must cover the deeper of the two rollbacks (None = unbounded)
        horizons = [self.low.replay_horizon(), self.high.replay_horizon()]
        if any(h is None for h in horizons):
            return None
        return max(horizons)

    def on_run_end(self) -> None:
        # both children may own background resources (statestore children
        # run an async snapshot writer even while shadowing)
        for child in self._children():
            child.on_run_end()

    # ---- wall-clock model --------------------------------------------
    def iteration_cost(self) -> float:
        return self.active.iteration_cost()

    def failure_cost(self) -> float:
        return self.active.failure_cost()

    def consume_restore_bytes(self):
        return self.active.consume_restore_bytes()

    def __repr__(self) -> str:
        return (f"Adaptive(low={self.low.name}, high={self.high.name}, "
                f"active={self.active.name}, rate={self.failure_rate():.3f})")
