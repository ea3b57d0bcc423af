"""Adapters: how the rest of the stack consumes a simulated cluster.

:class:`SimFailureSchedule` wraps a :class:`~repro_torch.sim.cluster.SimResult`
behind the legacy :class:`repro_torch.core.failures.FailureSchedule` contract
(``.events`` / ``.at(step)`` / ``len`` / ``summary``), so ``Trainer`` and
every benchmark accept it unchanged — and it adds the three per-event
wall-clock hooks the trainer upgrades to when present:

``iteration_factor(step)``
    multiplier on the strategy's ``iteration_cost()`` for that wall
    iteration (slow/spare hosts stretch the pipeline);
``failure_overhead(step, stage, nbytes=None)``
    extra modelled seconds for that failure event (replacement-node restart
    latency + shipping one stage of state over its bandwidth), charged on
    top of the strategy's ``failure_cost()``; strategies that know the
    actual serialized bytes they restored (``repro_torch.statestore``) pass
    ``nbytes`` and the transfer is repriced per event;
``observed_rate(step)``
    the cluster's trailing-window failures-per-iteration — the environment
    signal the ``adaptive`` strategy switches on instead of only its own
    window.

:func:`simulate` is the one-call entry point:

    schedule = simulate("spot_diurnal", steps=4000, seed=42)
    Trainer(model, tcfg, schedule=schedule).run(batches)

A copy of ``repro.sim.adapters`` on the port's ``WallClockModel`` and
telemetry (the ``sim_run`` event of :func:`simulate`).
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from repro_torch import telemetry
from repro_torch.core.walltime import WallClockModel
from repro_torch.sim.cluster import Cluster, SimResult
from repro_torch.sim.scenario import ScenarioConfig, get_scenario


class SimFailureSchedule:
    """Legacy-schedule view of a simulated run, plus wall-clock hooks."""

    def __init__(self, result: SimResult, rate_window: int = 32):
        self.result = result
        self.events = result.events
        self.steps = result.steps
        self.num_stages = result.num_stages
        self.rate = result.scenario.rate_per_hour
        self.iter_time = result.scenario.iteration_time_s
        self._by_step = {}
        for e in self.events:
            self._by_step.setdefault(e.step, []).append(e.stage)
        self._departed_by_step = {}
        for step, stage in result.departures:
            self._departed_by_step.setdefault(step, []).append(stage)
        self._regrown_by_step = {}
        for step, stage in result.regrows:
            self._regrown_by_step.setdefault(step, []).append(stage)
        self.rate_window = max(rate_window, 1)
        counts = np.zeros(result.steps + 1, np.float64)
        for e in self.events:
            counts[e.step + 1] += 1
        self._cum_failures = np.cumsum(counts)

    # ---- the legacy FailureSchedule contract -------------------------
    def at(self, step: int) -> List[int]:
        return self._by_step.get(step, [])

    def __len__(self) -> int:
        return len(self.events)

    def summary(self) -> str:
        r = self.result
        return (f"{len(self.events)} stage failures over {r.steps} iters "
                f"({r.total_hours:.1f} simulated h, "
                f"scenario={r.scenario.name!r}, seed={r.seed})")

    # ---- elastic repartitioning hooks --------------------------------
    def departed_at(self, step: int) -> List[int]:
        """Stages whose node permanently departed at ``step`` (these also
        appear in ``at(step)`` — a departure is a failure plus a vacancy)."""
        return self._departed_by_step.get(step, [])

    def regrown_at(self, step: int) -> List[int]:
        """Departed slots that received fresh capacity at ``step``."""
        return self._regrown_by_step.get(step, [])

    # ---- per-event wall-clock source ---------------------------------
    def iteration_factor(self, step: int) -> float:
        """Iteration-time multiplier at ``step`` (slowest active host)."""
        if 0 <= step < len(self.result.iter_factors):
            return float(self.result.iter_factors[step])
        return 1.0

    def iteration_factor_active(self, step: int,
                                slots: List[int]) -> float:
        """Iteration-time multiplier over only ``slots`` — the pace an
        elastic trainer pays after shrinking away departed slots.  A slot
        that is departed but still in ``slots`` (a strategy that declined
        to repartition) is priced at the degraded spare penalty, exactly
        like :meth:`iteration_factor` would."""
        arr = self.result.stage_slowdowns
        if arr is None or not (0 <= step < len(arr)) or not slots:
            return self.iteration_factor(step)
        penalty = self.result.scenario.spare_penalty
        vals = [penalty if np.isnan(arr[step, s]) else float(arr[step, s])
                for s in slots]
        return float(max(vals))

    def failure_overhead(self, step: int, stage: int,
                         nbytes: Optional[float] = None) -> float:
        """Node-dependent extra seconds for the failure at (step, stage).

        With ``nbytes`` (the serialized state a recovery strategy actually
        shipped — e.g. one statestore shard) the transfer is repriced from
        the event's recorded restart latency and replacement-node
        bandwidth; without it the precomputed one-stage estimate stands.
        """
        if nbytes is None:
            return self.result.overheads.get((step, stage), 0.0)
        costs = self.result.event_costs.get((step, stage))
        if costs is None:
            return self.result.overheads.get((step, stage), 0.0)
        latency_s, bandwidth_Bps = costs
        if bandwidth_Bps <= 0 or bandwidth_Bps == float("inf"):
            return latency_s
        return latency_s + nbytes / bandwidth_Bps

    # ---- environment signal ------------------------------------------
    def observed_rate(self, step: int) -> float:
        """Failures per wall iteration over the trailing window at
        ``step`` (what a cluster-side monitor would report)."""
        if step <= 0:
            return 0.0
        hi = min(step, self.steps)
        lo = max(hi - self.rate_window, 0)
        if hi == lo:
            return 0.0
        return float((self._cum_failures[hi] - self._cum_failures[lo])
                     / (hi - lo))

    def __repr__(self) -> str:
        return f"SimFailureSchedule({self.summary()})"


def simulate(scenario: Union[str, ScenarioConfig], *, steps: int,
             seed: int = 0, num_stages: Optional[int] = None,
             protect_edges: Optional[bool] = None,
             wall: Optional[WallClockModel] = None,
             rate_window: int = 32) -> SimFailureSchedule:
    """Run the cluster simulator and return its trainer-ready schedule view.

    ``num_stages`` / ``protect_edges`` override the scenario (they are
    model/strategy properties, not environment properties); ``wall``
    supplies the per-stage state size that prices recovery transfers.
    """
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    overrides = {}
    if num_stages is not None:
        overrides["num_stages"] = num_stages
    if protect_edges is not None:
        overrides["protect_edges"] = protect_edges
    if overrides:
        import dataclasses
        scenario = dataclasses.replace(scenario, **overrides)
    wall = wall or WallClockModel()
    cluster = Cluster(scenario, steps=steps, seed=seed,
                      stage_bytes=wall.stage_bytes(scenario.num_stages))
    result = cluster.run()
    telemetry.emit("sim_run", scenario=scenario.name, steps=steps,
                   events=len(result.events),
                   suppressed=len(result.suppressed),
                   total_hours=result.total_hours)
    return SimFailureSchedule(result, rate_window=rate_window)
