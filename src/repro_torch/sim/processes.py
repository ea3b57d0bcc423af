"""Failure arrival processes.

A :class:`FailureProcess` decides which stages' hosts die during one
simulated iteration.  The cluster event loop calls
``failed_stages(step, t_h, dt_h, stages, node_at)`` once per iteration with
the candidate stage range (edge protection already applied) and a
``stage -> Node`` accessor for age/heterogeneity-aware hazards; the process
returns the raw candidate failures, and the cluster applies the paper's
no-two-adjacent-stages constraint on top.

``bernoulli`` is the legacy-compatibility process: it draws exactly one
uniform per candidate stage per step against the *nominal* per-iteration
probability (``rate * iteration_time / 3600``), in ascending stage order —
the same RNG consumption pattern as
:class:`repro_torch.core.failures.FailureSchedule`, which makes a simulated
``bernoulli`` run bit-identical to the legacy schedule for matched
(rate, iteration time, stages, seed).  Every other process is genuinely
time-driven: its per-step hazard integrates the actual (stretched)
iteration duration, so slow nodes see proportionally more exposure.

A copy of ``repro.sim.processes``: the same generator calls in the same
order, so a seed gives the same events in both packages.
"""
from __future__ import annotations

import json
import math
from typing import Callable, List, Sequence

import numpy as np

from repro_torch.sim.node import Node
from repro_torch.sim.scenario import ScenarioConfig

NodeAt = Callable[[int], Node]


class FailureProcess:
    """Base class; subclasses implement :meth:`failed_stages`."""

    def __init__(self, sc: ScenarioConfig, rng: np.random.Generator):
        self.sc = sc
        self.rng = rng

    def failed_stages(self, step: int, t_h: float, dt_h: float,
                      stages: Sequence[int], node_at: NodeAt) -> List[int]:
        raise NotImplementedError

    @staticmethod
    def _p_from_hazard(integrated_hazard: float) -> float:
        """Probability of >=1 failure given the integrated hazard over the
        iteration window (exact for a Poisson thinning)."""
        return 1.0 - math.exp(-max(integrated_hazard, 0.0))


class BernoulliProcess(FailureProcess):
    """Legacy-compatible per-iteration coin (see module docstring)."""

    def __init__(self, sc: ScenarioConfig, rng: np.random.Generator):
        super().__init__(sc, rng)
        # the legacy clamp, verbatim: extreme rate x iteration-time products
        # must stay a valid probability
        self.p_iter = min(max(
            sc.rate_per_hour * sc.iteration_time_s / 3600.0, 0.0), 1.0)

    def failed_stages(self, step, t_h, dt_h, stages, node_at):
        # one scalar draw per stage in ascending order — identical RNG
        # consumption to FailureSchedule's inner loop
        return [s for s in stages if self.rng.random() < self.p_iter]


class HazardProcess(FailureProcess):
    """Time-varying per-stage hazard rate, integrated over the iteration."""

    def rate_at(self, t_h: float, node: Node) -> float:
        """Instantaneous per-hour failure rate for ``node`` at ``t_h``."""
        return self.sc.rate_per_hour

    def failed_stages(self, step, t_h, dt_h, stages, node_at):
        mid = t_h + 0.5 * dt_h
        out = []
        for s in stages:
            p = self._p_from_hazard(self.rate_at(mid, node_at(s)) * dt_h)
            if self.rng.random() < p:
                out.append(s)
        return out


class PoissonProcess(HazardProcess):
    """Constant-rate exponential inter-arrival times per stage."""


class DiurnalProcess(HazardProcess):
    """Spot-market preemption with a 24 h cycle peaking at
    ``diurnal_peak_h`` (demand-driven reclaims cluster in business hours)."""

    def rate_at(self, t_h, node):
        sc = self.sc
        phase = 2.0 * math.pi * (t_h - sc.diurnal_peak_h) / 24.0
        return max(sc.rate_per_hour * (1.0 +
                                       sc.diurnal_amplitude * math.cos(phase)),
                   0.0)


class FlashCrowdProcess(HazardProcess):
    """Calm background rate with one correlated preemption storm."""

    def rate_at(self, t_h, node):
        sc = self.sc
        if sc.burst_start_h <= t_h < sc.burst_start_h + sc.burst_len_h:
            return sc.burst_rate_per_hour
        return sc.rate_per_hour


class WeibullProcess(HazardProcess):
    """Weibull wear-out: hazard grows with node uptime (shape > 1), so the
    respawn/rejoin policy visibly changes the failure dynamics.  The scale
    is calibrated per node so its mean lifetime matches ``Node.mtbf_hours``
    (the cluster seeds that from ``1 / rate_per_hour``)."""

    def __init__(self, sc: ScenarioConfig, rng: np.random.Generator):
        super().__init__(sc, rng)
        self.shape = sc.weibull_shape
        self._mean_gamma = math.gamma(1.0 + 1.0 / self.shape)

    def failed_stages(self, step, t_h, dt_h, stages, node_at):
        k = self.shape
        out = []
        for s in stages:
            node = node_at(s)
            age = node.age_h(t_h)
            lam = node.mtbf_hours / self._mean_gamma
            # integrated hazard H(age+dt) - H(age), H(t) = (t/lambda)^k
            dH = ((age + dt_h) / lam) ** k - (age / lam) ** k
            if self.rng.random() < self._p_from_hazard(dH):
                out.append(s)
        return out


class TraceProcess(FailureProcess):
    """Replay a recorded preemption trace.

    Format (JSONL, one event per line; ``#`` lines and blanks ignored):

        {"t_h": 2.5, "stage": 3}

    ``t_h`` is the event time in hours since run start; ``stage`` the
    0-based tower stage whose host is preempted.  Events are consumed in
    time order; an event lands on the iteration whose simulated window
    ``[t, t + dt)`` contains it.  Events on protected/out-of-range stages
    are skipped (counted in ``skipped``).
    """

    def __init__(self, sc: ScenarioConfig, rng: np.random.Generator):
        super().__init__(sc, rng)
        self.trace = load_trace(sc.trace_path)
        self._cursor = 0
        self.skipped = 0

    def failed_stages(self, step, t_h, dt_h, stages, node_at):
        valid = set(stages)
        out = []
        end = t_h + dt_h
        while (self._cursor < len(self.trace)
               and self.trace[self._cursor][0] < end):
            _, stage = self.trace[self._cursor]
            self._cursor += 1
            if stage in valid:
                out.append(stage)
            else:
                self.skipped += 1
        return sorted(set(out))


def load_trace(path: str) -> List[tuple]:
    """Parse a JSONL trace file into a time-sorted ``[(t_h, stage), ...]``."""
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
                events.append((float(rec["t_h"]), int(rec["stage"])))
            except (ValueError, KeyError) as e:
                raise ValueError(
                    f"{path}:{lineno}: bad trace line {line!r}") from e
    events.sort(key=lambda e: e[0])
    return events


_PROCESSES = {
    "bernoulli": BernoulliProcess,
    "poisson": PoissonProcess,
    "diurnal": DiurnalProcess,
    "flash": FlashCrowdProcess,
    "weibull": WeibullProcess,
    "trace": TraceProcess,
}


def register_process(name: str, cls: type) -> type:
    """Make a custom :class:`FailureProcess` selectable by
    ``ScenarioConfig(process=name)`` (``ScenarioConfig.validate`` checks
    this registry, so registration is all a plugin needs)."""
    assert issubclass(cls, FailureProcess), cls
    if name in _PROCESSES and _PROCESSES[name] is not cls:
        raise ValueError(f"process {name!r} already registered "
                         f"({_PROCESSES[name].__name__})")
    _PROCESSES[name] = cls
    return cls


def available_processes() -> list:
    return sorted(_PROCESSES)


def make_process(sc: ScenarioConfig,
                 rng: np.random.Generator) -> FailureProcess:
    return _PROCESSES[sc.process](sc, rng)
