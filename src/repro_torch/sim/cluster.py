"""The discrete-event cluster loop.

:class:`Cluster` maps pipeline stages onto :class:`~repro_torch.sim.node.Node`
hosts and advances simulated time one *wall iteration* at a time (the
trainer consumes failures at iteration boundaries, so iterations are the
natural event granularity).  Each tick:

1. nodes whose restart finished rejoin their stage (``rejoin`` policy);
2. the iteration duration is the nominal iteration time stretched by the
   slowest participating host (stragglers and spare hosts stall the whole
   pipeline);
3. the failure process draws candidate stage failures for the elapsed
   window; the paper's no-two-adjacent-stages constraint is applied in
   ascending stage order (identical to the legacy schedule);
4. every accepted failure prices its recovery — restart latency plus
   shipping one stage of state over the replacement host's bandwidth —
   and the stage's host is respawned (fresh node, fresh wear-out clock)
   or sent into restart with a slow spare filling in.

Two RNG streams keep scenarios reproducible *and* the ``bernoulli``
process bit-compatible with the legacy schedule: the failure process owns
``default_rng(seed)`` exclusively (consuming exactly what
``FailureSchedule`` would), while node/infrastructure randomness draws
from an independent stream.

A copy of ``repro.sim.cluster`` on the port's ``FailureEvent`` and
telemetry: a ``sim_node`` event for each entry of the node log, and the
``sim_run`` span around :meth:`Cluster.run`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import telemetry
from repro_torch.core.failures import FailureEvent
from repro_torch.sim.node import Node
from repro_torch.sim.processes import FailureProcess, make_process
from repro_torch.sim.scenario import ScenarioConfig


@dataclass
class SimResult:
    """Everything one simulated run produced (wrapped for the trainer by
    :class:`repro_torch.sim.adapters.SimFailureSchedule`)."""

    scenario: ScenarioConfig
    steps: int
    seed: int
    num_stages: int
    protect_edges: bool
    events: List[FailureEvent]
    # candidate failures the no-two-adjacent-stages constraint suppressed
    # (nothing disappears silently — trace replays especially)
    suppressed: List[FailureEvent]
    # per-event recovery overhead in seconds, keyed by (step, stage)
    overheads: Dict[Tuple[int, int], float]
    iter_factors: np.ndarray        # [steps] iteration-time multiplier
    times_h: np.ndarray             # [steps] sim time at each step start
    # (kind, step, stage, node_id) with kind in
    # {"fail", "respawn", "rejoin", "depart", "regrow"}
    node_log: List[Tuple[str, int, int, int]] = field(default_factory=list)
    # per-event (restart latency s, replacement bandwidth B/s): the raw
    # pricing inputs behind ``overheads``, kept so the adapter can reprice
    # a transfer with the *actual* bytes a recovery strategy shipped
    # (statestore shards) instead of the default one-stage estimate
    event_costs: Dict[Tuple[int, int], Tuple[float, float]] = \
        field(default_factory=dict)
    # permanent departures and the fresh capacity that later replaced them,
    # as (step, stage); every departure also appears in ``events``
    departures: List[Tuple[int, int]] = field(default_factory=list)
    regrows: List[Tuple[int, int]] = field(default_factory=list)
    # [steps, num_stages] effective slowdown per slot (NaN while the slot
    # is departed) — lets an elastic trainer pace iterations over only the
    # slots it actually runs on, while ``iter_factors`` keeps charging the
    # degraded spare penalty for consumers that stay at K stages
    stage_slowdowns: Optional[np.ndarray] = None

    @property
    def total_hours(self) -> float:
        if not len(self.times_h):
            return 0.0
        last_dt = self.scenario.iteration_time_s * self.iter_factors[-1] / 3600
        return float(self.times_h[-1] + last_dt)


class Cluster:
    """Stages -> nodes with churn; ``run()`` executes the event loop."""

    def __init__(self, scenario: ScenarioConfig, *, steps: int, seed: int = 0,
                 stage_bytes: float = 0.0):
        scenario.validate()
        self.sc = scenario
        self.steps = steps
        self.seed = seed
        self.stage_bytes = stage_bytes
        # process stream == legacy stream (bernoulli bit-parity); node and
        # infrastructure randomness must not touch it
        self.process: FailureProcess = make_process(
            scenario, np.random.default_rng(seed))
        self._infra_rng = np.random.default_rng([seed, 0xC7])
        self._next_id = 0
        self.nodes: Dict[int, Node] = {
            s: self._fresh_node(0.0) for s in range(scenario.num_stages)}
        # rejoin policy: stage -> (original node, sim time it comes back)
        self._restarting: Dict[int, Tuple[Node, float]] = {}
        # permanent departures: stage -> sim time fresh capacity arrives
        # (inf = never); a departed slot cannot fail again and runs NaN in
        # ``stage_slowdowns`` until it regrows
        self._departed: Dict[int, float] = {}

    def _fresh_node(self, t_h: float) -> Node:
        sc = self.sc
        slowdown = (sc.slow_factor
                    if self._infra_rng.random() < sc.slow_fraction else 1.0)
        node = Node(node_id=self._next_id, slowdown=slowdown,
                    mtbf_hours=1.0 / max(sc.rate_per_hour, 1e-9),
                    restart_latency_s=sc.restart_latency_s,
                    bandwidth_Bps=sc.bandwidth_Bps, joined_h=t_h)
        self._next_id += 1
        return node

    def _effective_slowdown(self, stage: int) -> float:
        # a stage whose host is restarting runs on a shared spare that
        # stalls the pipeline at spare_penalty x nominal speed; a departed
        # slot is priced the same way in the degraded (stay-at-K) view
        if stage in self._restarting or stage in self._departed:
            return self.sc.spare_penalty
        return self.nodes[stage].slowdown

    def run(self) -> SimResult:
        sc = self.sc
        lo = 1 if sc.protect_edges else 0
        hi = sc.num_stages - 1 if sc.protect_edges else sc.num_stages
        candidates = list(range(lo, hi))
        node_at = self.nodes.__getitem__

        events: List[FailureEvent] = []
        suppressed: List[FailureEvent] = []
        overheads: Dict[Tuple[int, int], float] = {}
        event_costs: Dict[Tuple[int, int], Tuple[float, float]] = {}
        factors = np.ones(self.steps, np.float64)
        times = np.zeros(self.steps, np.float64)
        slowdowns = np.ones((self.steps, sc.num_stages), np.float64)
        departures: List[Tuple[int, int]] = []
        regrows: List[Tuple[int, int]] = []
        log = []

        t_span = telemetry.clock()
        t_h = 0.0
        for step in range(self.steps):
            # 1) finished restarts rejoin their stage; departed slots whose
            #    replacement capacity arrived regrow with a fresh node
            for stage, (node, ready_h) in list(self._restarting.items()):
                if t_h >= ready_h:
                    node.joined_h = t_h
                    self.nodes[stage] = node
                    del self._restarting[stage]
                    log.append(("rejoin", step, stage, node.node_id))
                    telemetry.emit("sim_node", what="rejoin", step=step,
                                   stage=stage, node_id=node.node_id)
            for stage, ready_h in list(self._departed.items()):
                if t_h >= ready_h:
                    node = self._fresh_node(t_h)
                    self.nodes[stage] = node
                    del self._departed[stage]
                    regrows.append((step, stage))
                    log.append(("regrow", step, stage, node.node_id))
                    telemetry.emit("sim_node", what="regrow", step=step,
                                   stage=stage, node_id=node.node_id)

            # 2) this iteration runs at the slowest participant's pace
            factor = max(self._effective_slowdown(s)
                         for s in range(sc.num_stages))
            dt_h = sc.iteration_time_s * factor / 3600.0
            factors[step] = factor
            times[step] = t_h
            for s in range(sc.num_stages):
                slowdowns[step, s] = (np.nan if s in self._departed
                                      else self._effective_slowdown(s))

            # 3) candidate failures over the elapsed window; adjacency
            #    constraint applied in ascending stage order (paper §3);
            #    a departed slot has no node left to fail
            accepted: List[int] = []
            for stage in self.process.failed_stages(
                    step, t_h, dt_h, candidates, node_at):
                if stage in self._departed:
                    suppressed.append(FailureEvent(step, stage))
                    continue
                if any(abs(stage - a) <= 1 for a in accepted):
                    suppressed.append(FailureEvent(step, stage))
                    continue
                accepted.append(stage)

            # 4) price and apply each failure
            for stage in accepted:
                dead = self.nodes[stage]
                events.append(FailureEvent(step, stage))
                # the departure coin rides the infra stream, drawn only when
                # the scenario can depart — existing schedules stay
                # bit-identical (both RNG streams consume exactly what they
                # used to when depart_prob == 0 and rejoin != "never")
                departs = sc.rejoin == "never" or (
                    sc.depart_prob > 0.0
                    and self._infra_rng.random() < sc.depart_prob)
                if departs:
                    departures.append((step, stage))
                    log.append(("depart", step, stage, dead.node_id))
                    telemetry.emit("sim_node", what="depart", step=step,
                                   stage=stage, node_id=dead.node_id,
                                   overhead_s=0.0)
                    self._restarting.pop(stage, None)
                    ready = (t_h + sc.regrow_h
                             if sc.regrow_h != float("inf") else float("inf"))
                    self._departed[stage] = ready
                    # no replacement to ship state to: the in-place view
                    # pays through the spare penalty in ``iter_factors``,
                    # the elastic view through the re-layout pricing
                    overheads[(step, stage)] = 0.0
                    event_costs[(step, stage)] = (0.0, sc.bandwidth_Bps)
                    continue
                log.append(("fail", step, stage, dead.node_id))
                if sc.rejoin == "rejoin":
                    # the node itself comes back after its restart latency;
                    # until then a spare stalls the pipeline (priced through
                    # iter_factors), so only the state transfer is charged
                    overheads[(step, stage)] = dead.transfer_time_s(
                        self.stage_bytes)
                    event_costs[(step, stage)] = (0.0, dead.bandwidth_Bps)
                    ready = t_h + dt_h + dead.restart_latency_s / 3600.0
                    self._restarting[stage] = (dead, ready)
                    replacement = None
                else:  # respawn: a fresh node replaces it immediately
                    replacement = self._fresh_node(t_h)
                    overheads[(step, stage)] = (
                        replacement.restart_latency_s
                        + replacement.transfer_time_s(self.stage_bytes))
                    event_costs[(step, stage)] = (
                        replacement.restart_latency_s,
                        replacement.bandwidth_Bps)
                    self.nodes[stage] = replacement
                telemetry.emit("sim_node", what="fail", step=step,
                               stage=stage, node_id=dead.node_id,
                               overhead_s=overheads[(step, stage)])
                if replacement is not None:
                    log.append(("respawn", step, stage,
                                replacement.node_id))
                    telemetry.emit("sim_node", what="respawn", step=step,
                                   stage=stage,
                                   node_id=replacement.node_id)

            t_h += dt_h

        telemetry.complete("sim_run", t_span, cat="sim", scenario=sc.name,
                           steps=self.steps, events=len(events))
        return SimResult(scenario=sc, steps=self.steps, seed=self.seed,
                         num_stages=sc.num_stages,
                         protect_edges=sc.protect_edges,
                         events=events, suppressed=suppressed,
                         overheads=overheads,
                         iter_factors=factors, times_h=times, node_log=log,
                         event_costs=event_costs, departures=departures,
                         regrows=regrows, stage_slowdowns=slowdowns)
