"""Seeded stage-failure event generation.

The paper uses hourly per-stage failure probabilities (5% / 10% / 16%) and
replays the *same* failure pattern across recovery strategies for a fair
comparison (§5: "simulating the failures of different stages across
iterations, so that the failure patterns between tests are the same").
We reproduce that: a :class:`FailureSchedule` is derived once from
(rate, iteration_time, num_stages, seed) and consumed by every strategy.

Constraints honoured (paper §3): no two *consecutive* stages fail at once,
and with ``protect_edges=True`` the first/last transformer stages never fail
(plain CheckFree cannot recover them; only CheckFree+'s swap schedule makes
them losable, so ``protect_edges=False`` lets every tower stage fail,
including stage 0).  Stage indices are 0-based *within the transformer
tower*: the embedding stage (the paper's S0) sits outside this index space
entirely and is never simulated as failing.

A copy of ``repro.core.failures`` (numpy only): the same draws, so the same
events for a seed in both packages.  The port's trainer takes any object
with ``.at(step)`` (and the optional pricing hooks) in its place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass(frozen=True)
class FailureEvent:
    step: int
    stage: int  # 0-based transformer-stage index (within the tower)


class FailureSchedule:
    def __init__(self, *, rate_per_hour: float, iteration_time_s: float,
                 num_stages: int, steps: int, seed: int = 0,
                 protect_edges: bool = False):
        self.rate = rate_per_hour
        self.iter_time = iteration_time_s
        self.num_stages = num_stages
        self.steps = steps
        # per-iteration failure probability per stage; extreme
        # rate * iteration_time products must stay a valid probability
        self.p_iter = min(max(rate_per_hour * iteration_time_s / 3600.0, 0.0),
                          1.0)
        rng = np.random.default_rng(seed)
        events: List[FailureEvent] = []
        lo = 1 if protect_edges else 0
        hi = num_stages - 1 if protect_edges else num_stages
        for step in range(steps):
            failed_this_step: List[int] = []
            for stage in range(lo, hi):
                if rng.random() < self.p_iter:
                    # no two consecutive stages fail together (paper §3)
                    if any(abs(stage - f) <= 1 for f in failed_this_step):
                        continue
                    failed_this_step.append(stage)
                    events.append(FailureEvent(step, stage))
        self.events = events
        self._by_step: Dict[int, List[int]] = {}
        for e in events:
            self._by_step.setdefault(e.step, []).append(e.stage)

    def at(self, step: int) -> List[int]:
        return self._by_step.get(step, [])

    def __len__(self) -> int:
        return len(self.events)

    def summary(self) -> str:
        return (f"{len(self.events)} stage failures over {self.steps} iters "
                f"(p_iter={self.p_iter:.2e}, rate={self.rate:.0%}/h)")
