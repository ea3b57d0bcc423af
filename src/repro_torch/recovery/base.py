"""The :class:`RecoveryStrategy` contract: recovery policies as objects.

The counterpart of ``repro.recovery.base``, for the eager host trainer of
this slice.  A strategy owns the policy surface the trainer consults:

lifecycle hooks (called by the trainer)
  ``on_failure(state, event)``      — one stage died at an iteration boundary
  ``on_consecutive(state, run, event)`` — a run of adjacent stages died
                                      together (only if ``handles_consecutive``)
  ``on_departure(state, event)``    — a stage's node left for good and the
                                      trainer will shrink the layout; rebuild
                                      the stage's values in the old layout
  ``accept_repartition(event, bytes)`` — whether to shrink for a departure
  ``on_layout_change(state, old, new)`` — the trainer re-cut the stages
  ``after_step(state, hist)``       — bookkeeping after every wall iteration
  ``on_run_end()``                  — loop exit (even on error)
  ``observe_environment(rate)``     — the schedule's observed failure rate,
                                      once per wall iteration when available

wall-clock model
  ``iteration_cost()`` / ``failure_cost()`` — modelled seconds per wall
  iteration and per failure event; ``consume_restore_bytes()`` — bytes a
  replacement node had to receive for the event just handled (None: the
  schedule's own estimate)

capability flags (the trainer never looks at names)
  ``handles_edge_stages``  — recovers S_first/S_last; when False the strategy
                             degrades edge failures itself
  ``handles_consecutive``  — recovers a run of adjacent failed stages jointly
  ``uses_swap_schedule``   — the train step runs CheckFree+'s swapped stage
                             order on half the batch
  ``recover_by_repartition`` — wants the layout shrunk on a permanent
                             departure and grown back on a regrow (elastic)
  ``recover_in_mesh``      — repairs stages with the pipeline backend's
                             neighbour transfers when it offers them

horizons
  ``after_step_horizon(step)`` — how many iterations may run before
                             ``after_step`` must observe host state again
                             (for fused windows; the eager trainer's
                             windows are one step)
  ``replay_horizon()``     — how far ``effective_step`` can roll back on a
                             failure (bounds the trainer's batch replay
                             cache)

``bind(part, init_fn)`` gives a strategy the stage partition and a
from-scratch init (``() -> (params, opt_state)``, fresh tensors on the
trainer's device), for policies that may have to restart.  On the pipeline
backend (``Trainer(backend="spmd")``) the partition is the rank's view of
its shard (``pipeline.spmd.ShardPartition``), ``bind_in_mesh`` gives a
strategy that advertises ``recover_in_mesh`` the backend's recovery by
neighbour transfers (``pipeline.spmd.InMeshRecover``), and
``bind_group_reduce`` gives every strategy the stage group's all-reduce of
host numbers (``pipeline.spmd.GroupReduce``), through which the ranks agree
on what only some of them know; on the host backend ``group_reduce`` stays
None.

Strategies are made through the registry
(:func:`repro_torch.recovery.registry.make_strategy`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, ClassVar, List, Optional, Tuple, TYPE_CHECKING

import torch

from repro_torch import telemetry

if TYPE_CHECKING:  # pragma: no cover — typing only, no import cycles
    from repro_torch.config import RecoveryConfig
    from repro_torch.core.stages import StagePartition
    from repro_torch.core.state import History, TrainState
    from repro_torch.core.walltime import WallClockModel

# () -> (params, opt_state): a deterministic from-scratch reinitialization
InitFn = Callable[[], Tuple[Any, Any]]


@dataclass
class FailureContext:
    """Everything a strategy may consult when reacting to a failure event."""

    stage: int                   # 0-based failed stage (run[0] for runs)
    wall_step: int               # wall-iteration index of the event
    generator: torch.Generator   # random draws (random reinit ablation)
    hist: "History"              # strategies append recovery_errors here


class RecoveryStrategy:
    """Base class: a no-op policy (registered as ``none``)."""

    name: ClassVar[str] = "none"           # set by @register_strategy
    handles_edge_stages: ClassVar[bool] = True
    handles_consecutive: ClassVar[bool] = False
    uses_swap_schedule: ClassVar[bool] = False
    recover_by_repartition: ClassVar[bool] = False
    recover_in_mesh: ClassVar[bool] = False

    def __init__(self, rcfg: "RecoveryConfig", wall: "WallClockModel"):
        self.rcfg = rcfg
        self.wall = wall
        self.part: Optional["StagePartition"] = None
        self.init_fn: Optional[InitFn] = None
        self._in_mesh_recover: Optional[Callable] = None
        #: the stage group's all-reduce on the pipeline backend, else None
        self.group_reduce: Optional[Callable] = None

    # ---- trainer wiring ----------------------------------------------
    def bind(self, part: "StagePartition",
             init_fn: Optional[InitFn] = None) -> "RecoveryStrategy":
        """Attach the stage partition (and a from-scratch init for policies
        that may have to restart).  Called once by the trainer."""
        self.part = part
        self.init_fn = init_fn
        return self

    def bind_in_mesh(self, recover_fn: Callable) -> "RecoveryStrategy":
        """Attach the pipeline backend's recovery by neighbour transfers,
        ``recover(params, omegas, failed, reinit) -> params`` (with
        ``gathered`` and ``total``: ``pipeline.spmd.InMeshRecover``).
        Called by the trainer only when the backend offers one and the
        strategy advertises ``recover_in_mesh``."""
        self._in_mesh_recover = recover_fn
        return self

    def bind_group_reduce(self, reduce: Callable) -> "RecoveryStrategy":
        """Attach the pipeline backend's all-reduce of host numbers over the
        stage group, ``reduce(values, op) -> values`` (with ``rank``,
        ``min`` and ``share``: ``pipeline.spmd.GroupReduce``).  Called by
        the trainer on that backend, for every strategy; a strategy whose
        decisions rest on one rank's files or stores takes them through it,
        so that every rank decides alike."""
        self.group_reduce = reduce
        return self

    # ---- instrumented entry points (what the trainer calls) ----------
    def handle_failure(self, state: "TrainState",
                       event: FailureContext) -> "TrainState":
        """:meth:`on_failure` wrapped in a host-side trace span and a
        structured ``recovery`` event (``repro_torch.telemetry``).  The
        trainer routes failures through here so every policy's recovery is
        measured alike; subclasses override :meth:`on_failure` only.
        ``duration_s`` is host time around the handler: on the card the
        merge is enqueued, not waited for."""
        t0 = telemetry.clock()
        state = self.on_failure(state, event)
        duration = telemetry.clock() - t0
        telemetry.complete("recovery", t0, cat="recovery",
                           strategy=self.name, stage=event.stage)
        telemetry.emit("recovery", wall_step=event.wall_step,
                       stage=event.stage, strategy=self.name,
                       duration_s=duration, stages=[event.stage])
        return state

    def handle_consecutive(self, state: "TrainState", run: List[int],
                           event: FailureContext) -> "TrainState":
        """:meth:`on_consecutive`, as :meth:`handle_failure` (one
        ``recovery`` event for the whole run of adjacent stages)."""
        t0 = telemetry.clock()
        state = self.on_consecutive(state, run, event)
        duration = telemetry.clock() - t0
        telemetry.complete("recovery", t0, cat="recovery",
                           strategy=self.name, stage=event.stage,
                           stages=len(run))
        telemetry.emit("recovery", wall_step=event.wall_step,
                       stage=event.stage, strategy=self.name,
                       duration_s=duration, stages=list(run))
        return state

    def handle_departure(self, state: "TrainState",
                         event: FailureContext) -> "TrainState":
        """:meth:`on_departure`, as :meth:`handle_failure`.  Called instead
        of it when the failure is a permanent departure that the trainer
        will repartition away: the strategy only rebuilds the lost stage's
        values in the *old* layout; the trainer re-cuts the layout after."""
        t0 = telemetry.clock()
        state = self.on_departure(state, event)
        duration = telemetry.clock() - t0
        telemetry.complete("recovery", t0, cat="recovery",
                           strategy=self.name, stage=event.stage)
        telemetry.emit("recovery", wall_step=event.wall_step,
                       stage=event.stage, strategy=self.name,
                       duration_s=duration, stages=[event.stage])
        return state

    # ---- lifecycle ---------------------------------------------------
    def on_failure(self, state: "TrainState",
                   event: FailureContext) -> "TrainState":
        return state

    def on_consecutive(self, state: "TrainState", run: List[int],
                       event: FailureContext) -> "TrainState":
        """Default: recover each stage of the run independently."""
        for stage in run:
            state = self.on_failure(state, replace(event, stage=stage))
        return state

    def on_departure(self, state: "TrainState",
                     event: FailureContext) -> "TrainState":
        """A permanent departure rebuilds the stage as a failure does; the
        re-layout that follows is the trainer's (it owns the partition and
        the fused window), not the strategy's."""
        return self.on_failure(state, event)

    def accept_repartition(self, event: FailureContext,
                           moved_bytes: float) -> bool:
        """Whether to shrink the layout for this departure (``moved_bytes``:
        the state the re-layout would move).  Consulted only when
        ``recover_by_repartition`` is set; ``adaptive`` prices it against
        staying degraded."""
        return True

    def on_layout_change(self, state: "TrainState", old: "StagePartition",
                         new: "StagePartition") -> "TrainState":
        """The trainer re-cut the stage layout (a shrink after a departure,
        a grow on a regrow).  Rebind the partition and refresh per-stage
        state; store-backed strategies re-shard their snapshots here."""
        self.part = new
        return state

    def after_step(self, state: "TrainState", hist: "History") -> None:
        pass

    def on_run_end(self) -> None:
        """Called once when the trainer's loop exits (even on error)."""

    def observe_environment(self, rate: float) -> None:
        """The schedule's observed failure rate (failures per wall
        iteration); ignored by default."""

    # ---- fused-window contract ---------------------------------------
    def after_step_horizon(self, step: int) -> Optional[int]:
        """How many consecutive iterations, starting from effective step
        ``step``, may run before ``after_step`` must observe host state
        again.  ``None`` means unbounded; ``1`` pins the eager loop.  A
        strategy that keeps the no-op ``after_step`` fuses freely; one that
        overrides it is pinned to 1 unless it overrides this too."""
        if type(self).after_step is RecoveryStrategy.after_step:
            return None
        return 1

    def replay_horizon(self) -> Optional[int]:
        """How many iterations ``effective_step`` can move *backwards* on a
        failure: the trainer evicts cached batches older than this.
        ``None`` keeps every batch; the base policy never rolls back (0)."""
        return 0

    # ---- wall-clock model --------------------------------------------
    def iteration_cost(self) -> float:
        return self.wall.iter_time_s

    def failure_cost(self) -> float:
        return 0.0

    def consume_restore_bytes(self) -> Optional[float]:
        """Serialized bytes that had to reach the replacement node for the
        failure event just handled, or ``None`` for the schedule's default
        estimate."""
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"
