"""Simulated cluster nodes.

A :class:`Node` is one pipeline-stage host on the simulated cluster:
heterogeneous compute (``slowdown`` stretches every iteration it
participates in — the pipeline runs at the pace of its slowest stage),
a mean time between failures, and the two quantities that price a
recovery event (restart latency and the bandwidth at which replacement
state reaches it).  Nodes are plain mutable records; all dynamics
(failures, restarts, respawns) live in :mod:`repro_torch.sim.cluster`.

A copy of ``repro.sim.node`` (the JAX package's simulator loads jax through
``repro.core``, so the port keeps its own).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Node:
    """One stage host on the simulated cluster."""

    node_id: int
    slowdown: float = 1.0            # iteration-time multiplier (>= 1 = slower)
    mtbf_hours: float = 10.0         # mean time between failures (wear-out base)
    restart_latency_s: float = 0.0   # redeploy time after a failure
    bandwidth_Bps: float = float("inf")  # state-transfer bandwidth to this node
    joined_h: float = 0.0            # sim time (hours) this node (re)joined

    def age_h(self, t_h: float) -> float:
        """Hours of continuous uptime at sim time ``t_h`` (wear-out clock)."""
        return max(t_h - self.joined_h, 0.0)

    def transfer_time_s(self, nbytes: float) -> float:
        """Seconds to ship ``nbytes`` of replacement state onto this node."""
        if self.bandwidth_Bps <= 0 or self.bandwidth_Bps == float("inf"):
            return 0.0
        return nbytes / self.bandwidth_Bps
