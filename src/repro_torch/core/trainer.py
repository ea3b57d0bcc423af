"""Failure-aware trainer: the paper's training loop with pluggable recovery
strategies, on the host, one step at a time.

The counterpart of ``repro.core.trainer`` on its host backend with
``fuse_window=1``.  The trainer executes *wall iterations*; a
:class:`~repro_torch.recovery.base.RecoveryStrategy` (made from
``RecoveryConfig`` through the registry) reacts to the failure events of a
schedule (any object with ``.at(step) -> [stages]``), changing the train
state (the CheckFree merge, a twin copy, ...) and pricing wall-clock through
its ``iteration_cost`` / ``failure_cost``.  The loop only consults the
strategy's hooks and capability flags, never its name.  CheckFree+'s
out-of-order microbatches run half the batch through the swapped stage
order (``core/swap.py``).

Each step is one forward and backward through ``Model.loss`` on fp32 master
parameters (cast to ``cfg.dtype`` inside the graph), the per-stage squared
gradient norms (Alg. 1's omega), and one in-place Adam update.  On the card
the attention forward and backward and every merge run the hand-written
CUDA kernels; on the CPU their plain versions.  The host reads one number a
step (the loss) and one per failure (its recovery error).

When the schedule exposes ``iteration_factor`` / ``failure_overhead`` the
loop prices iterations and recoveries with them, and when it exposes
``observed_rate`` the strategy receives the failure rate each wall
iteration, as in the JAX trainer.

Batches are drawn by effective step from a replay cache
(:class:`~repro_torch.data.pipeline.ReplayCache`, bounded by the strategy's
``replay_horizon``), so a rollback replays the lost steps' batches.  The
strategy is bound with a from-scratch init (the run's starting parameters
again, with zero moments) for restarts.  The state is updated in place, so
strategies that save it copy it out, and restores copy into the live
tensors.

Not ported yet: fused windows and CUDA graphs (ROADMAP.md queue 1, item 3),
the SPMD pipeline backend, simulated-cluster scenarios, elastic
repartitioning (item 5) and telemetry events (item 6).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.config import TrainConfig
from repro_torch.core.stages import StagePartition
from repro_torch.core.state import History, TrainState
from repro_torch.core.swap import swap_permutation
from repro_torch.core.walltime import WallClockModel
from repro_torch.data.pipeline import ReplayCache
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.optim.adam import adam_update, init_adam
from repro_torch.recovery import FailureContext, RecoveryStrategy, make_strategy
from repro_torch.telemetry import log

Params = Any
Batch = Dict[str, torch.Tensor]
_F32 = np.float32


def make_loss_fn(model: Model, part: StagePartition, use_swap: bool,
                 ) -> Callable[[Params, Batch], Tuple[torch.Tensor, dict]]:
    """The (possibly swap-scheduled) loss shared by every step
    (``_make_loss_fn`` of the JAX trainer)."""
    if use_swap:
        order = swap_permutation(
            part.num_layers, part.num_stages,
            bounds=[part.stage_bounds(i) for i in range(part.num_stages)],
        ).tolist()

    def loss_fn(params: Params, batch: Batch):
        if not use_swap:
            return model.loss(params, batch)
        half = batch["tokens"].shape[0] // 2
        first = {k: v[:half] for k, v in batch.items()}
        second = {k: v[half:] for k, v in batch.items()}
        l1, m1 = model.loss(params, first)
        l2, m2 = model.loss(params, second, order=order)
        # the metrics cover the whole batch: average both halves'
        metrics = {k: 0.5 * (m1[k] + m2[k]) for k in m1}
        return 0.5 * (l1 + l2), metrics

    return loss_fn


class Trainer:
    """Drives (model x recovery strategy x failure schedule), eagerly.

    ``model`` gives the config and the device (``Model(cfg,
    weights=False)``: the trainer keeps its own fp32 master parameters).
    Training on the card is the default; a model built with
    ``device="cpu"`` trains on the CPU with the kernels' plain versions.
    """

    def __init__(self, model: Model, tcfg: TrainConfig,
                 wall: Optional[WallClockModel] = None, schedule=None):
        self.model = model
        self.device = model.device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; build the model with "
                               "device='cpu' to train on the CPU")
        self.tcfg = tcfg
        self.rcfg = tcfg.recovery
        if schedule is None and self.rcfg.scenario:
            raise NotImplementedError(
                "simulated-cluster scenarios (repro.sim) are not ported yet; "
                "pass a schedule object with .at(step)")
        self.part = StagePartition(model.cfg, self.rcfg.num_stages)
        self.strategy: RecoveryStrategy = make_strategy(self.rcfg, wall=wall)
        if self.strategy.recover_by_repartition:
            raise NotImplementedError(
                f"strategy {self.strategy.name!r} repartitions on departures; "
                "elastic repartitioning is not ported yet (ROADMAP.md queue 1, "
                "item 5)")
        self.wall = self.strategy.wall
        self.schedule = schedule
        # the run's starting parameters as a host copy, when the caller gave
        # them (run(params=...)); fresh_init re-draws from the seed otherwise
        self._init_host: Optional[Params] = None
        self.strategy.bind(self.part, init_fn=self.fresh_init)
        self.loss_fn = make_loss_fn(model, self.part,
                                    self.strategy.uses_swap_schedule)

    # ---- parameters and batches ---------------------------------------
    def init_params(self) -> Params:
        """Fresh fp32 masters from a generator seeded with ``tcfg.seed`` on
        the device (not JAX's draws: ``run(params=...)`` takes those)."""
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
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
    def step(self, state: TrainState, batch: Batch,
             ) -> Tuple[TrainState, torch.Tensor, Dict[str, Any]]:
        """Forward, backward, omegas, Adam: one effective step.

        Returns the new state, the loss (a 0-d tensor on the device) and the
        step's metrics (``ce``, ``aux``, ``grad_norm``, ``lr``).
        """
        params = state.params
        loss, metrics = self.loss_fn(params, batch)
        loss.backward()
        grads = TR.map(lambda p: p.grad, params)
        omegas = self.part.stage_grad_sqnorms(grads)
        params, opt_state, opt_metrics = adam_update(
            self.tcfg.optimizer, params, grads, state.opt_state,
            state.lr_scale)
        for p in TR.leaves(params):
            p.grad = None
        # the CheckFree LR-boost decay, in fp32 as the JAX scan carry
        ls = _F32(state.lr_scale)
        lr_scale = float(_F32(1) + (ls - _F32(1)) *
                         _F32(self.rcfg.lr_boost_decay))
        metrics = {**metrics, **opt_metrics}
        state = TrainState(params, opt_state, lr_scale, omegas.detach(),
                           state.effective_step + 1)
        return state, loss.detach(), metrics

    @torch.no_grad()
    def eval_loss(self, params: Params, batch: Batch) -> torch.Tensor:
        cfg = self.model.cfg
        logits = T.forward(L.cast_tree(params, cfg.dtype), cfg,
                           batch["tokens"])
        return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))

    # ---- main loop ----------------------------------------------------
    def run(self, batches: Iterable[Dict[str, np.ndarray]],
            eval_batches: Optional[List] = None, params: Optional[Params] = None,
            verbose: bool = False) -> Tuple[TrainState, History]:
        """Train ``tcfg.steps`` effective steps on ``batches`` (numpy dicts).

        ``params`` (default: :meth:`init_params`) are the initial parameters,
        e.g. JAX's ``model.init`` through ``convert.params_from_numpy``.
        """
        tcfg = self.tcfg
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
        evals = ([self.device_batch(eb) for eb in eval_batches]
                 if eval_batches else None)
        replay = ReplayCache(batches)
        max_wall = tcfg.steps * 10  # safety bound for rollback-heavy runs
        try:
            state, hist, wall_step = self._loop(state, hist, replay, evals,
                                                max_wall, verbose)
        finally:
            self.strategy.on_run_end()
        hist.wall_iters = wall_step
        if state.effective_step < tcfg.steps:
            hist.truncated = True
            warnings.warn(
                f"Trainer.run truncated at max_wall={max_wall} wall "
                f"iterations (effective_step={state.effective_step}/"
                f"{tcfg.steps}); results are incomplete", RuntimeWarning,
                stacklevel=2)
        return state, hist

    def _event_generator(self) -> torch.Generator:
        seed = int(self._event_rng.integers(0, 2 ** 62))
        return torch.Generator(self.device).manual_seed(seed)

    def _handle_failures(self, state: TrainState, hist: History,
                         clock: float, wall_step: int,
                         failure_overhead) -> Tuple[TrainState, float]:
        """Failures arrive at iteration boundaries; runs of consecutive
        stages are recovered together when the strategy can.  No ported
        strategy repartitions, so a permanent departure is recovered like a
        transient failure."""
        strategy = self.strategy
        stages = [s for s in sorted(self.schedule.at(wall_step))
                  if 0 <= s < self.part.num_stages]

        def charge(stage: int) -> None:
            nonlocal clock
            hist.failures.append((wall_step, stage))
            clock += strategy.failure_cost()
            nbytes = strategy.consume_restore_bytes()
            if failure_overhead is not None:
                clock += (failure_overhead(wall_step, stage) if nbytes is None
                          else failure_overhead(wall_step, stage, nbytes))

        runs: List[List[int]] = []
        for stage in stages:
            if runs and stage == runs[-1][-1] + 1:
                runs[-1].append(stage)
            else:
                runs.append([stage])
        for run in runs:
            event = FailureContext(stage=run[0], wall_step=wall_step,
                                   generator=self._event_generator(),
                                   hist=hist)
            if len(run) > 1 and strategy.handles_consecutive:
                state = strategy.handle_consecutive(state, run, event)
            else:
                for stage in run:
                    state = strategy.handle_failure(
                        state, dataclasses.replace(event, stage=stage))
            for stage in run:
                charge(stage)
        return state, clock

    def _loop(self, state, hist, replay, evals, max_wall, verbose):
        tcfg = self.tcfg
        strategy = self.strategy
        iter_factor = getattr(self.schedule, "iteration_factor", None)
        failure_overhead = getattr(self.schedule, "failure_overhead", None)
        observed_rate = getattr(self.schedule, "observed_rate", None)
        horizon = strategy.replay_horizon()
        clock = 0.0
        wall_step = 0
        while state.effective_step < tcfg.steps and wall_step < max_wall:
            if observed_rate is not None:
                strategy.observe_environment(observed_rate(wall_step))
            if self.schedule is not None:
                state, clock = self._handle_failures(state, hist, clock,
                                                     wall_step,
                                                     failure_overhead)
            batch = replay.get(state.effective_step)
            state, loss, _ = self.step(state, self.device_batch(batch))
            hist.dispatches += 1
            factor = iter_factor(wall_step) if iter_factor is not None else 1.0
            clock += strategy.iteration_cost() * factor
            hist.steps.append(state.effective_step)
            hist.wall_time.append(clock)
            hist.loss.append(loss.item())
            strategy.after_step(state, hist)
            if horizon is not None:
                replay.evict_below(state.effective_step - horizon)
            if evals and state.effective_step % tcfg.eval_every == 0:
                el = float(np.mean([self.eval_loss(state.params, eb).item()
                                    for eb in evals]))
                hist.eval_loss.append((state.effective_step, clock, el))
                if verbose:
                    log(f"  step {state.effective_step:4d} wall "
                        f"{clock / 3600:7.2f}h loss {hist.loss[-1]:.3f} "
                        f"eval {el:.3f}")
            wall_step += 1
        return state, hist, wall_step
