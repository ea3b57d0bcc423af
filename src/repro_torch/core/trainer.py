"""Failure-aware trainer: the paper's training loop with pluggable recovery
strategies, in fused windows, on the host backend or the pipeline-parallel
one.

The counterpart of ``repro.core.trainer``.  The trainer
executes *wall iterations*; a :class:`~repro_torch.recovery.base.
RecoveryStrategy` (made from ``RecoveryConfig`` through the registry) reacts
to the failure events of a schedule (any object with ``.at(step) ->
[stages]``), changing the train state (the CheckFree merge, a twin copy, a
rollback, ...) and pricing wall-clock through its ``iteration_cost`` /
``failure_cost``.  The loop only consults the strategy's hooks and
capability flags, never its name.  CheckFree+'s out-of-order microbatches
run half the batch through the swapped stage order (``core/swap.py``).

Each step is one forward and backward through ``Model.loss`` on fp32 master
parameters (cast to ``cfg.dtype`` inside the graph), the per-layer and total
squared gradient norms in one pass (``ops.adam_sumsq``; the stages' omegas,
Alg. 1, are their segment sums), and one in-place Adam update on device
scalars (``optim.adam.adam_step``).  Every family the port trains (dense,
MoE, ssm, hybrid) goes through ``Model.loss`` and evaluates through it.  On the
card the attention forward and backward, the SSD scan and its backward,
both Adam kernels and every merge run the hand-written CUDA kernels; on the
CPU their plain versions.

**Fused windows** (``tcfg.fuse_window`` > 1, 8 by default as in JAX): the
failure schedule is known ahead, so between failure events the loop runs K
uninterrupted steps as one window (``core/window.py``): a CUDA graph
replayed K times on the card, with no host read inside; the step's metrics
gather in a device ring, drained with one copy a window.  A window ends at a
scheduled failure, an eval point, the strategy's ``after_step_horizon`` or
the end of the run, and its size is bucketed to powers of two
(:func:`_window_buckets`, :meth:`Trainer._window_size`, as JAX's).  The next
window's batches are stacked on a worker thread
(:class:`~repro_torch.data.pipeline.WindowPrefetcher`) while the current
one runs.  With ``fuse_window=1`` the loop runs the eager
:meth:`Trainer.step`, one step a dispatch, reading the loss back each step.

The ``schedule`` may be the seeded :class:`~repro_torch.core.failures.
FailureSchedule`, a simulated cluster's ``SimFailureSchedule``
(:mod:`repro_torch.sim`, built from ``rcfg.scenario`` when no schedule is
given) or any object with ``.at(step)``.  When it exposes
``iteration_factor`` / ``failure_overhead`` the loop prices iterations and
recoveries with them, and when it exposes ``observed_rate`` the strategy
receives the failure rate each wall iteration, as in the JAX trainer.

**Elastic repartitioning.**  A strategy with ``recover_by_repartition``
(``elastic``, ``adaptive``) answers a permanent departure
(``schedule.departed_at``) by rebuilding the lost stage in the old layout and
then re-cutting the pipeline over the surviving K-1 cluster slots
(:meth:`Trainer._repartition`); a regrow (``schedule.regrown_at``) grows it
back.  The tower stays one resident tensor: a re-layout changes the stage
bounds, never the values.  It rebuilds the loss and gives the loop a new
:class:`~repro_torch.core.window.FusedWindow` for the new cut, whose first
window captures anew after the old graph's pool went back; a shrunk layout
is paced by its surviving slots only (``iteration_factor_active``).

Batches are drawn by effective step from the prefetcher's replay cache
(bounded by the strategy's ``replay_horizon``), so a rollback replays the
lost steps' batches.  The strategy is bound with a from-scratch init (the
run's starting parameters again, with zero moments) for restarts.  The
state is updated in place, so strategies that save it copy it out, and
restores copy into the live tensors.

**Telemetry** (``repro_torch.telemetry``, the JAX trainer's sites): the
``run_start``, ``failure``, ``repartition``, ``step_window``, ``eval``,
``truncation`` and ``run_end`` events, and the ``window_dispatch``,
``window_drain`` and ``repartition`` spans.  The eager loop emits them as
windows of one step, as JAX's ``fuse_window=1`` does.  They take only host
values (python numbers, the drained ring), so a run with a recorder
installed makes no host read and no synchronize that a dark run does not.

**The pipeline-parallel backend** (``backend="spmd"``,
:mod:`repro_torch.pipeline.spmd`): one ``torch.distributed`` rank per stage
(``group``, or the default process group; ``launch.mesh.spawn_stages``
starts them), each running this loop on the same batches and schedule and
holding its slice of the tower, full copies of the other leaves and their
Adam moments.  A step is a GPipe schedule whose activations and their
gradients hop between the ranks, one all-reduce of the replicated leaves'
gradients and Adam on the rank's leaves; the ring's values are reduced over
the group, so every rank holds the same ones and makes the same decisions.
Windows run their steps eagerly: there is **no CUDA graph** on this
backend, since gloo's transfers run on the host (through pinned host
buffers on the card).  The CheckFree family recovers by neighbour transfers
into the failed rank, merged there by ``ops.stage_merge``.  The strategies
that snapshot or restore state keep per-rank shards in directories of each
rank's own under ``checkpoint_dir`` and ``store_dir``, and decide through
the group's all-reduce, which the trainer binds to every strategy here
(``bind_group_reduce``).  A repartitioning strategy degrades to in-place
recovery (the stage group is fixed); the backend refuses other families
than dense and MoE, a sliding window and a layer count the stages do not
divide (``pipeline.spmd.refusal``).  Only a rank that installed a
recorder records telemetry (rank 0, in the launcher), with
``backend="spmd"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch import tree as TR
from repro_torch.config import TrainConfig
from repro_torch.core.stages import (StagePartition, moved_layers,
                                     remap_stage_stats)
from repro_torch.core.state import History, TrainState
from repro_torch.core.swap import swap_permutation
from repro_torch.core.walltime import WallClockModel
from repro_torch.core.window import OMEGAS, RECORD, FusedWindow
from repro_torch.data.pipeline import WindowPrefetcher
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.optim.adam import OptState, adam_step, init_adam
from repro_torch.recovery import FailureContext, RecoveryStrategy, make_strategy
from repro_torch.telemetry import log

Params = Any
Batch = Dict[str, torch.Tensor]


class _TwinCast(torch.autograd.Function):
    """One cast of a leaf to the compute dtype, handed out twice (the two
    halves of a CheckFree+ batch), sharing one copy.  Each half's gradient
    comes back in fp32 and the two are summed in fp32, as two casts'
    gradients accumulate into the leaf; autograd would sum two uses of one
    cast in the compute dtype first."""

    @staticmethod
    def forward(ctx, p, dtype):
        c = p.to(dtype)
        return c, c.view_as(c)

    @staticmethod
    def backward(ctx, g1, g2):
        if g1 is None:
            g1, g2 = g2, None
        out = g1.float()
        if g2 is not None:
            out.add_(g2)            # in fp32: g2 is widened, then added
        return out, None


def twin_cast(tree: Params, dtype) -> Tuple[Params, Params]:
    """Two trees of ``tree``'s leaves in ``dtype`` from one copy of each:
    the same values and gradients as casting the tree once per half,
    without holding the compute-dtype tree twice (granite-moe-3b-a800m: 6.1
    GiB).  Leaves already in ``dtype`` are shared as they are."""
    if isinstance(tree, dict):
        pairs = {k: twin_cast(v, dtype) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    if torch.is_floating_point(tree) and tree.dtype != dtype:
        return _TwinCast.apply(tree, dtype)
    return tree, tree


def make_loss_fn(model: Model, part: StagePartition, use_swap: bool,
                 ) -> Callable[[Params, Batch], Tuple[torch.Tensor, dict]]:
    """The (possibly swap-scheduled) loss shared by every step
    (``_make_loss_fn`` of the JAX trainer).  The swapped half shares the
    first half's cast of the masters (:func:`twin_cast`)."""
    if use_swap:
        order = swap_permutation(
            part.num_layers, part.num_stages,
            bounds=[part.stage_bounds(i) for i in range(part.num_stages)],
        ).tolist()
    dtype = L.to_dtype(model.cfg.dtype)

    def loss_fn(params: Params, batch: Batch):
        if not use_swap:
            return model.loss(params, batch)
        half = batch["tokens"].shape[0] // 2
        first = {k: v[:half] for k, v in batch.items()}
        second = {k: v[half:] for k, v in batch.items()}
        p1, p2 = twin_cast(params, dtype)
        l1, m1 = model.loss(p1, first)
        l2, m2 = model.loss(p2, second, order=order)
        # the metrics cover the whole batch: average both halves'
        metrics = {k: 0.5 * (m1[k] + m2[k]) for k in m1}
        return 0.5 * (l1 + l2), metrics

    return loss_fn


@dataclasses.dataclass(frozen=True)
class ScheduleHooks:
    """The schedule's optional hooks, None where it has none; the elastic
    ones only for a strategy that repartitions."""
    iteration_factor: Optional[Callable[[int], float]] = None
    failure_overhead: Optional[Callable[..., float]] = None
    observed_rate: Optional[Callable[[int], float]] = None
    departed_at: Optional[Callable[[int], List[int]]] = None
    regrown_at: Optional[Callable[[int], List[int]]] = None
    iteration_factor_active: Optional[Callable[[int, List[int]], float]] = None

    @classmethod
    def of(cls, schedule, elastic: bool) -> "ScheduleHooks":
        def hook(name: str, allowed: bool = True):
            return getattr(schedule, name, None) if allowed else None
        return cls(hook("iteration_factor"), hook("failure_overhead"),
                   hook("observed_rate"), hook("departed_at", elastic),
                   hook("regrown_at", elastic),
                   hook("iteration_factor_active", elastic))


def _window_buckets(cap: int) -> List[int]:
    """Descending power-of-two window sizes <= cap (always ending in 1)
    (``repro/core/trainer.py:200-211``)."""
    buckets = []
    k = 1
    while k <= cap:
        buckets.append(k)
        k *= 2
    return buckets[::-1]


class Trainer:
    """Drives (model x recovery strategy x failure schedule).

    ``model`` gives the config and the device (``Model(cfg,
    weights=False)``: the trainer keeps its own fp32 master parameters).
    Training on the card is the default; a model built with
    ``device="cpu"`` trains on the CPU with the kernels' plain versions.
    """

    def __init__(self, model: Model, tcfg: TrainConfig,
                 wall: Optional[WallClockModel] = None, schedule=None, *,
                 backend: str = "host", group=None):
        self.model = model
        self.device = model.device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; build the model with "
                               "device='cpu' to train on the CPU")
        if backend not in ("host", "spmd"):
            raise ValueError(f"unknown backend {backend!r}; expected 'host' "
                             "or 'spmd'")
        self.backend = backend
        self.tcfg = tcfg
        self.rcfg = tcfg.recovery
        if backend == "spmd":
            # deferred: only pipeline runs load the backend
            from repro_torch.pipeline import spmd
            why = spmd.refusal(model.cfg, self.rcfg.num_stages)
            if why:
                raise ValueError(why)
        self.part = StagePartition(model.cfg, self.rcfg.num_stages)
        self.strategy: RecoveryStrategy = make_strategy(self.rcfg, wall=wall)
        self.wall = self.strategy.wall
        if schedule is None and self.rcfg.scenario:
            # deferred: the simulator is only loaded by runs that use it
            from repro_torch.sim import simulate
            schedule = simulate(
                self.rcfg.scenario, steps=tcfg.steps * 10,
                seed=self.rcfg.seed, num_stages=self.rcfg.num_stages,
                protect_edges=self.rcfg.protect_edge_stages, wall=self.wall)
        self.schedule = schedule
        # the run's starting parameters as a host copy, when the caller gave
        # them (run(params=...)); fresh_init re-draws from the seed otherwise
        self._init_host: Optional[Params] = None
        self._buckets = _window_buckets(max(int(tcfg.fuse_window), 1))
        # window sizes dispatched, as the JAX trainer keeps them
        self.dispatched_buckets: set = set()
        self._evals: Optional[List[Batch]] = None
        if backend == "spmd":
            self._init_spmd(group)
        else:
            self.strategy.bind(self.part, init_fn=self.fresh_init)
            self.loss_fn = make_loss_fn(model, self.part,
                                        self.strategy.uses_swap_schedule)
            #: runs the fused windows of the current layout
            self.window = FusedWindow(self._body, self.device, self.part)

        # ---- elastic repartitioning ---------------------------------------
        # partition stage index -> cluster slot: the identity until a
        # permanent departure shrinks the layout (the slots keep their
        # identity in the schedule; the partition re-cuts over survivors)
        self._slots: List[int] = list(range(self.rcfg.num_stages))
        self._hooks = ScheduleHooks.of(
            schedule, backend == "host" and
            bool(self.strategy.recover_by_repartition))
        #: (wall_step, direction, from_k, to_k, moved_layers, cost_s)
        self.repartition_log: List[Tuple[int, str, int, int, int, float]] = []

    def _init_spmd(self, group) -> None:
        """The pipeline backend: the stage group, the rank's view of its
        shard for the strategy, the group's all-reduce and the in-mesh
        recovery for it, the step and its window
        (``repro/core/trainer.py:256-269, 290-299``).  The strategies put
        this rank's checkpoints and stores in its own directories under the
        configured ones (``statestore.store.rank_dirs``), since each wipes
        its directory when it starts.  Every rank sizes its
        windows alike: ``after_step_horizon`` reads only the effective step,
        which a rollback sets to the group's step on every rank, and the
        replayed batches are drawn by that step."""
        from repro_torch.launch.mesh import make_stage_group
        from repro_torch.pipeline import spmd
        from repro_torch.pipeline.transport import Transport
        sg = make_stage_group(self.rcfg.num_stages, group)
        self.rank = sg.rank
        self.transport = Transport(sg, self.device)
        self.strategy.bind(spmd.ShardPartition(self.model.cfg,
                                               self.part.num_stages, sg.rank),
                           init_fn=self.fresh_init)
        if self.strategy.recover_by_repartition:
            log(f"strategy {self.strategy.name!r} advertises repartition but "
                "the spmd backend has a fixed mesh: permanent departures "
                "degrade to in-place recovery on a spare")
        self.strategy.bind_group_reduce(spmd.GroupReduce(self.transport))
        if self.strategy.recover_in_mesh:
            self.strategy.bind_in_mesh(
                spmd.make_in_mesh_recover(self.transport, self.part))
        self.pipeline = spmd.SpmdStep(
            self.model.cfg, self.part, self.transport, self.tcfg.optimizer,
            self.tcfg.num_microbatches,
            use_swap=self.strategy.uses_swap_schedule,
            lr_decay=self.rcfg.lr_boost_decay)
        # the step body of both loops: the rank's part of the schedule
        self._body = self.pipeline.body
        self._eval_fn = spmd.pipeline_loss(
            self.model.cfg, self.part, self.transport,
            self.tcfg.num_microbatches, ce_only=True)
        self.window = spmd.SpmdWindow(self._body, self.device, self.part)

    # ---- parameters and batches ---------------------------------------
    def init_params(self) -> Params:
        """Fresh fp32 masters from a generator seeded with ``tcfg.seed`` on
        the device (not JAX's draws: ``run(params=...)`` takes those).  On
        the pipeline backend the rank's shard of the same draws."""
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        if self.backend == "spmd":
            from repro_torch.pipeline.spmd import init_shard
            return init_shard(self.model.cfg, gen, self.device, self.part,
                              self.rank)
        return self.model.init(gen)

    def fresh_init(self) -> Tuple[Params, Any]:
        """(params, Adam state) as at the start of the run, as new tensors on
        the device: the counterpart of the JAX trainer's ``fresh_init``
        (``model.init(PRNGKey(seed))`` with zero moments), for strategies
        that restart from scratch."""
        if self._init_host is None:
            params = self.init_params()
        else:
            params = TR.map(lambda t: t.to(self.device, torch.float32,
                                           copy=True), self._init_host)
        return params, init_adam(params)

    def device_batch(self, batch: Dict[str, np.ndarray]) -> Batch:
        """A numpy batch as tensors on the trainer's device."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def init_state(self, params: Optional[Params] = None) -> TrainState:
        """Step 0: ``params`` (default: :meth:`init_params`) as trainable
        fp32 leaves on the device, with zero Adam moments.  Tensors already
        there are shared with the caller: training updates them in place."""
        def leaf(t: torch.Tensor) -> torch.Tensor:
            t = t.detach().to(device=self.device, dtype=torch.float32)
            return t.requires_grad_()
        params = TR.map(leaf, self.init_params() if params is None else params)
        return TrainState(params, init_adam(params))

    # ---- one step ------------------------------------------------------
    def _body(self, params: Params, m: List[torch.Tensor],
              v: List[torch.Tensor], batch: Batch, step: torch.Tensor,
              lr_scale: torch.Tensor) -> torch.Tensor:
        """One step on device scalars, no host read: forward, backward, the
        squared norms, Adam, the lr-boost decay of ``lr_scale`` (in place,
        in fp32 as the JAX scan carry).  ``step`` (0-d int32) counts the
        step.  Returns the step's record (``core.window.RECORD``, then the
        omegas) as an fp32 vector on the device."""
        loss, metrics = self.loss_fn(params, batch)
        loss.backward()
        leaves = TR.leaves(params)
        grads = [p.grad for p in leaves]
        with torch.no_grad():
            per_layer, total = ops.adam_sumsq(
                grads, self.part.tower_flags(params), self.part.num_layers)
            omegas = self.part.stage_sums(per_layer)
            grad_norm = total.sqrt()
            scalars = adam_step(self.tcfg.optimizer, leaves, grads, m, v,
                                step, lr_scale, grad_norm)
            for p in leaves:
                p.grad = None
            lr = scalars[1]
            lr_scale.sub_(1).mul_(self.rcfg.lr_boost_decay).add_(1)
            return torch.cat([
                torch.stack([loss.detach(), metrics["ce"].detach(),
                             metrics["aux"].detach(), grad_norm, lr, lr_scale,
                             step.float()]),
                omegas])

    def step(self, state: TrainState, batch: Batch,
             ) -> Tuple[TrainState, torch.Tensor, Dict[str, Any]]:
        """Forward, backward, omegas, Adam: one effective step, eagerly,
        reading the decayed ``lr_scale`` back to the host state.

        Returns the new state, the loss (a 0-d tensor on the device) and the
        step's metrics (``ce``, ``aux``, ``grad_norm``, ``lr``: 0-d tensors).
        """
        opt = state.opt_state
        step = torch.full((), opt.step, dtype=torch.int32, device=self.device)
        lr_scale = torch.full((), state.lr_scale, dtype=torch.float32,
                              device=self.device)
        rec = self._body(state.params, TR.leaves(opt.m), TR.leaves(opt.v),
                         batch, step, lr_scale)
        # the body decayed lr_scale on the device; the host state holds it
        lr_scale = float(rec[RECORD.index("lr_scale")])
        metrics = {name: rec[RECORD.index(name)]
                   for name in ("ce", "aux", "grad_norm", "lr")}
        state = TrainState(state.params, OptState(opt.m, opt.v, opt.step + 1),
                           lr_scale, rec[OMEGAS:], state.effective_step + 1)
        return state, rec[RECORD.index("loss")], metrics

    @torch.no_grad()
    def eval_loss(self, params: Params, batch: Batch) -> torch.Tensor:
        """The cross-entropy of ``batch`` through the family's forward (JAX's
        ``make_eval_step`` through ``model.apply``); on the pipeline backend
        through the pipeline, the same on every rank."""
        if self.backend == "spmd":
            return self._eval_fn(params, batch)
        return self.model.loss(params, batch)[1]["ce"]

    # ---- window sizing -------------------------------------------------
    def _window_size(self, wall_step: int, effective_step: int,
                     max_wall: int) -> int:
        """Largest bucketed K such that steps [wall_step, wall_step+K) are
        failure- and regrow-free after the first, no interior step needs
        host state (strategy horizon / eval), and the run doesn't overshoot
        (``repro/core/trainer.py:304-333``)."""
        cap = self._buckets[0]
        cap = min(cap, self.tcfg.steps - effective_step)
        cap = min(cap, max_wall - wall_step)
        horizon = self.strategy.after_step_horizon(effective_step)
        if horizon is not None:
            cap = min(cap, horizon)
        if self._evals:
            ev = self.tcfg.eval_every
            cap = min(cap, ev - effective_step % ev)
        if self.schedule is not None:
            regrown_at = self._hooks.regrown_at
            for i in range(1, cap):
                # a regrow re-cuts the layout: the window ends there too
                if self.schedule.at(wall_step + i) or (
                        regrown_at is not None and regrown_at(wall_step + i)):
                    cap = i
                    break
        for k in self._buckets:
            if k <= cap:
                return k
        return 1

    # ---- fused windows -------------------------------------------------
    def run_window(self, state: TrainState,
                   stacked: Dict[str, np.ndarray]
                   ) -> Tuple[TrainState, np.ndarray]:
        """One fused window of ``stacked`` (k numpy batches on a leading
        axis) from ``state`` -> (the state after it, its ring: k rows of
        ``core.window.RECORD`` then the omegas, on the host)."""
        return self.window.drain(self.window.dispatch(state, stacked,
                                                      part=self.part))

    # ---- elastic re-layout --------------------------------------------
    def _repartition(self, state: TrainState, new_slots: List[int], *,
                     wall_step: int, direction: str
                     ) -> Tuple[TrainState, float]:
        """Re-cut the stage layout over the cluster slots ``new_slots``: a
        balanced partition, the loss and a fused window for it, the
        strategy's per-stage state re-sharded, the omegas re-bucketed, and
        the moved layers priced over the wall model's link
        (``repro/core/trainer.py:349-380``)."""
        old_part, old_slots = self.part, self._slots
        new_part = StagePartition(self.model.cfg, len(new_slots))
        moved = moved_layers(old_part, old_slots, new_part, new_slots)
        nbytes = moved * self.wall.layer_bytes(old_part.num_layers)
        t0 = telemetry.clock()
        self.part = new_part
        self._slots = list(new_slots)
        self.loss_fn = make_loss_fn(self.model, new_part,
                                    self.strategy.uses_swap_schedule)
        # the old graph summed the omegas over the old cut: its pool goes
        # back before the new window's capture
        self.window = self.window.relayout(new_part)
        # one window size per bucket and layout epoch
        self.dispatched_buckets = set()
        state = self.strategy.on_layout_change(state, old_part, new_part)
        state = dataclasses.replace(
            state, omegas=remap_stage_stats(old_part, new_part, state.omegas))
        cost = self.wall.relayout_time_s(nbytes)
        telemetry.complete("repartition", t0, cat="trainer",
                           direction=direction, to_stages=new_part.num_stages)
        telemetry.emit(
            "repartition", wall_step=wall_step, direction=direction,
            from_stages=old_part.num_stages, to_stages=new_part.num_stages,
            moved_layers=int(moved), nbytes=float(nbytes), cost_s=cost)
        self.repartition_log.append(
            (wall_step, direction, old_part.num_stages, new_part.num_stages,
             int(moved), cost))
        return state, cost

    def _iteration_factor(self, wall_step: int) -> float:
        """The schedule's stretch of wall iteration ``wall_step``: a shrunk
        layout is paced by its surviving slots only."""
        hooks = self._hooks
        if hooks.iteration_factor_active is not None and \
                len(self._slots) < self.rcfg.num_stages:
            return hooks.iteration_factor_active(wall_step, self._slots)
        if hooks.iteration_factor is not None:
            return hooks.iteration_factor(wall_step)
        return 1.0

    def _boundary(self, state: TrainState, hist: History, clock: float,
                  wall_step: int) -> Tuple[TrainState, float]:
        """The work at the boundary before wall iteration ``wall_step``, in
        the JAX trainer's order (``repro/core/trainer.py:563-583``): the
        observed failure rate to the strategy, a grow on fresh capacity,
        then the failures (departures first)."""
        hooks = self._hooks
        if hooks.observed_rate is not None:
            self.strategy.observe_environment(hooks.observed_rate(wall_step))
        if hooks.regrown_at is not None and \
                len(self._slots) < self.rcfg.num_stages:
            back = [s for s in hooks.regrown_at(wall_step)
                    if s not in self._slots]
            if back:
                state, cost = self._repartition(
                    state, sorted(self._slots + back), wall_step=wall_step,
                    direction="grow")
                clock += cost
        if self.schedule is not None:
            state, clock = self._handle_failures(state, hist, clock,
                                                 wall_step)
        return state, clock

    # ---- main loop ----------------------------------------------------
    def run(self, batches: Iterable[Dict[str, np.ndarray]],
            eval_batches: Optional[List] = None, params: Optional[Params] = None,
            verbose: bool = False) -> Tuple[TrainState, History]:
        """Train ``tcfg.steps`` effective steps on ``batches`` (numpy dicts):
        in fused windows when ``tcfg.fuse_window`` > 1, else eagerly.

        ``params`` (default: :meth:`init_params`) are the initial parameters,
        e.g. JAX's ``model.init`` through ``convert.params_from_numpy``; on
        the pipeline backend each rank keeps its shard of them.
        """
        tcfg = self.tcfg
        if params is not None and self.backend == "spmd":
            from repro_torch.pipeline.spmd import shard_params
            params = shard_params(params, self.part, self.rank)
        # taken before init_state, which trains tensors already on the
        # device in place
        self._init_host = (None if params is None else
                           TR.map(lambda t: t.detach().to("cpu", copy=True),
                                  params))
        state = self.init_state(params)
        hist = History()
        # the failure events' random draws: a stream of its own, apart from
        # the parameters' init
        self._event_rng = np.random.default_rng([tcfg.seed, 1])
        self._evals = ([self.device_batch(eb) for eb in eval_batches]
                       if eval_batches else None)
        prefetch = WindowPrefetcher(batches)
        # the per-family FLOP estimate (6 * active params * tokens for
        # training) that the report turns into an MFU figure
        tokens = tcfg.global_batch * tcfg.seq_len
        telemetry.emit(
            "run_start", arch=self.model.cfg.name,
            strategy=self.strategy.name, backend=self.backend,
            steps=tcfg.steps,
            num_stages=self.rcfg.num_stages,
            flops_per_step=6 * self.model.cfg.active_param_count() * tokens,
            tokens_per_step=tokens)
        max_wall = tcfg.steps * 10  # safety bound for rollback-heavy runs
        # the pipeline backend runs windows of one for fuse_window 1, as
        # JAX's fused loop does (each dispatch in its pipeline span)
        fused = tcfg.fuse_window > 1 or self.backend == "spmd"
        loop = self._loop_fused if fused else self._loop
        try:
            # on the card a fused run's work between windows runs on the
            # windows' stream, sharing its cached blocks
            with (self.window.streamed() if fused else
                  contextlib.nullcontext()):
                state, hist, wall_step, clock = loop(state, hist, prefetch,
                                                     max_wall, verbose)
        finally:
            prefetch.close()
            self.strategy.on_run_end()
        hist.wall_iters = wall_step
        if state.effective_step < tcfg.steps:
            hist.truncated = True
            telemetry.emit(
                "truncation", wall_iters=wall_step,
                effective_step=state.effective_step, target_steps=tcfg.steps)
            warnings.warn(
                f"Trainer.run truncated at max_wall={max_wall} wall "
                f"iterations (effective_step={state.effective_step}/"
                f"{tcfg.steps}); results are incomplete", RuntimeWarning,
                stacklevel=2)
        telemetry.emit(
            "run_end", effective_steps=state.effective_step,
            wall_iters=hist.wall_iters, dispatches=hist.dispatches,
            failures=len(hist.failures), truncated=hist.truncated,
            clock_s=clock)
        return state, hist

    def _event_generator(self) -> torch.Generator:
        seed = int(self._event_rng.integers(0, 2 ** 62))
        return torch.Generator(self.device).manual_seed(seed)

    def _handle_failures(self, state: TrainState, hist: History,
                         clock: float, wall_step: int
                         ) -> Tuple[TrainState, float]:
        """Failures arrive at iteration boundaries
        (``repro/core/trainer.py:443-538``).  The schedule names cluster
        slots, the recovery math partition stages: the same until the first
        shrink.  Permanent departures come first: rebuilt in the old layout
        when the strategy accepts the priced re-layout and more than two
        stages would remain, then shrunk away together after the transient
        failures (and declined departures), whose runs of consecutive stages
        are recovered together when the strategy can."""
        strategy = self.strategy
        failure_overhead = self._hooks.failure_overhead
        slots = sorted(self.schedule.at(wall_step))
        departed_at = self._hooks.departed_at
        departed = (set(departed_at(wall_step)) if departed_at is not None
                    else set())
        slot_to_stage = {s: i for i, s in enumerate(self._slots)}

        def charge(slot: int) -> None:
            nonlocal clock
            hist.failures.append((wall_step, slot))
            cost = strategy.failure_cost()
            clock += cost
            nbytes = strategy.consume_restore_bytes()
            overhead = 0.0
            if failure_overhead is not None:
                overhead = (failure_overhead(wall_step, slot) if nbytes is None
                            else failure_overhead(wall_step, slot, nbytes))
                clock += overhead
            telemetry.emit("failure", wall_step=wall_step, stage=slot,
                           cost_s=cost, overhead_s=overhead, nbytes=nbytes)

        # 1) departures: rebuild in the old layout, shrink after
        shrink: List[int] = []
        transient: List[Tuple[int, int]] = []        # (slot, stage)
        for slot in slots:
            stage = slot_to_stage.get(slot)
            if stage is None:
                continue          # departed at an earlier boundary
            if slot in departed and len(self._slots) - len(shrink) > 2:
                event = FailureContext(stage=stage, wall_step=wall_step,
                                       generator=self._event_generator(),
                                       hist=hist)
                survivors = [s for s in self._slots
                             if s != slot and s not in shrink]
                moved = moved_layers(
                    self.part, self._slots,
                    StagePartition(self.model.cfg, len(survivors)), survivors)
                if strategy.accept_repartition(
                        event, moved * self.wall.layer_bytes(
                            self.part.num_layers)):
                    state = strategy.handle_departure(state, event)
                    shrink.append(slot)
                    charge(slot)
                    continue
            transient.append((slot, stage))

        # 2) transient failures, by runs of consecutive partition stages
        runs: List[List[Tuple[int, int]]] = []
        for slot, stage in transient:
            if runs and stage == runs[-1][-1][1] + 1:
                runs[-1].append((slot, stage))
            else:
                runs.append([(slot, stage)])
        for run in runs:
            event = FailureContext(stage=run[0][1], wall_step=wall_step,
                                   generator=self._event_generator(),
                                   hist=hist)
            if len(run) > 1 and strategy.handles_consecutive:
                state = strategy.handle_consecutive(
                    state, [stage for _, stage in run], event)
            else:
                for _, stage in run:
                    state = strategy.handle_failure(
                        state, dataclasses.replace(event, stage=stage))
            for slot, _ in run:
                charge(slot)

        # 3) one shrink covers every accepted departure at this boundary
        if shrink:
            state, cost = self._repartition(
                state, [s for s in self._slots if s not in shrink],
                wall_step=wall_step, direction="shrink")
            clock += cost
        return state, clock

    def _evaluate(self, state: TrainState, hist: History, clock: float,
                  verbose: bool) -> None:
        """The eval losses at an eval point, at a window boundary."""
        if not (self._evals and
                state.effective_step % self.tcfg.eval_every == 0):
            return
        el = float(np.mean([self.eval_loss(state.params, eb).item()
                            for eb in self._evals]))
        hist.eval_loss.append((state.effective_step, clock, el))
        telemetry.emit("eval", step=state.effective_step, loss=el,
                       clock_s=clock)
        if verbose:
            log(f"  step {state.effective_step:4d} wall "
                f"{clock / 3600:7.2f}h loss {hist.loss[-1]:.3f} "
                f"eval {el:.3f}")

    def _loop(self, state, hist, prefetch, max_wall, verbose):
        """One eager step a wall iteration (``fuse_window=1``), with the
        telemetry of a window of one step (JAX's ``fuse_window=1`` is its
        fused loop with windows of one)."""
        tcfg = self.tcfg
        strategy = self.strategy
        horizon = strategy.replay_horizon()
        clock = 0.0
        wall_step = 0
        while state.effective_step < tcfg.steps and wall_step < max_wall:
            state, clock = self._boundary(state, hist, clock, wall_step)
            batch = prefetch.get(state.effective_step)
            t0 = telemetry.clock()
            state, loss, _ = self.step(state, self.device_batch(batch))
            telemetry.complete("window_dispatch", t0, cat="trainer", k=1,
                               wall_step=wall_step, backend=self.backend)
            hist.dispatches += 1
            self.dispatched_buckets.add(1)
            # the step's one read of its loss
            with telemetry.span("window_drain", cat="trainer", k=1):
                loss = loss.item()
            factor = self._iteration_factor(wall_step)
            clock += strategy.iteration_cost() * factor
            hist.steps.append(state.effective_step)
            hist.wall_time.append(clock)
            hist.loss.append(loss)
            telemetry.emit("step_window", wall_step=wall_step, k=1,
                           effective_step=state.effective_step, loss=loss,
                           clock_s=clock, stretch=factor)
            strategy.after_step(state, hist)
            if horizon is not None:
                prefetch.evict_below(state.effective_step - horizon)
            self._evaluate(state, hist, clock, verbose)
            wall_step += 1
        return state, hist, wall_step, clock

    def _loop_fused(self, state, hist, prefetch, max_wall, verbose):
        """Fused windows, in the order of ``repro/core/trainer.py:585-668``:
        failures at the boundary, the window, one drain, per-iteration
        pricing and history, ``after_step`` once, eviction, eval."""
        tcfg = self.tcfg
        strategy = self.strategy
        observed_rate = self._hooks.observed_rate
        replay = strategy.replay_horizon()
        loss_col = RECORD.index("loss")
        clock = 0.0
        wall_step = 0
        while state.effective_step < tcfg.steps and wall_step < max_wall:
            state, clock = self._boundary(state, hist, clock, wall_step)
            # the window: k steps, one dispatch, no host read inside (on the
            # current layout's window: a re-layout at the boundary made anew)
            k = self._window_size(wall_step, state.effective_step, max_wall)
            runner = self.window
            stacked = prefetch.take(state.effective_step, k)
            t0 = telemetry.clock()
            pending = runner.dispatch(state, stacked, part=self.part)
            telemetry.complete("window_dispatch", t0, cat="trainer", k=k,
                               wall_step=wall_step, backend=self.backend)
            hist.dispatches += 1
            self.dispatched_buckets.add(k)
            # while the card runs this window, line up the next one (a
            # failure at the boundary replays from the cache instead)
            next_k = self._window_size(wall_step + k,
                                       state.effective_step + k, max_wall)
            if state.effective_step + k < tcfg.steps:
                prefetch.prime(state.effective_step + k, next_k)
            # one copy to the host for the window's k steps
            with telemetry.span("window_drain", cat="trainer", k=k):
                state, ring = runner.drain(pending)
            stretch = 0.0
            for i in range(k):
                if i > 0 and observed_rate is not None:
                    strategy.observe_environment(observed_rate(wall_step + i))
                factor = self._iteration_factor(wall_step + i)
                clock += strategy.iteration_cost() * factor
                stretch += factor
                hist.steps.append(state.effective_step - k + i + 1)
                hist.wall_time.append(clock)
                hist.loss.append(float(ring[i, loss_col]))
            telemetry.emit("step_window", wall_step=wall_step, k=k,
                           effective_step=state.effective_step,
                           loss=hist.loss[-1], clock_s=clock,
                           stretch=stretch / k)
            # interior steps were certified skippable by after_step_horizon
            strategy.after_step(state, hist)
            if replay is not None:
                prefetch.evict_below(state.effective_step - replay)
            self._evaluate(state, hist, clock, verbose)
            wall_step += k
        return state, hist, wall_step, clock
