"""Scenario registry: named cluster environments for the simulator.

A :class:`ScenarioConfig` fully describes a simulated environment — the
failure process and its parameters, the node pool (heterogeneity, restart
latency, bandwidth), and the rejoin policy.  Scenarios are frozen
dataclasses resolved by name through :func:`get_scenario`, mirroring the
recovery-strategy registry so benchmarks can sweep ``scenarios x
strategies`` symmetrically.

Built-ins:

======================  =====================================================
``bernoulli``           legacy-compatible per-iteration coin; homogeneous
                        nodes, zero recovery overhead — bit-identical to
                        :class:`repro_torch.core.failures.FailureSchedule` for a
                        given (rate, iteration time, stages, seed)
``paper_5pct`` /        the paper's 5/10/16 %/h Bernoulli churn, plus
``paper_10pct`` /       realistic node costs (60 s restarts, 500 Mb/s
``paper_16pct``         state transfer)
``spot_diurnal``        spot-market preemption with a time-of-day cycle,
                        heterogeneous nodes, rejoin-after-restart dynamics
``flash_crowd``         calm Poisson background with a correlated
                        preemption storm (mass spot reclaim)
``spot_shrink``         spot reclaims are *permanent* (``rejoin="never"``):
                        a departed slot only returns when fresh capacity
                        arrives after ``regrow_h`` — the elastic
                        repartitioning scenario
``wearout``             Weibull wear-out hazard: freshly (re)started nodes
                        are reliable, old ones increasingly fail
``trace:<file>``        replay a recorded preemption trace (JSONL, one
                        ``{"t_h": ..., "stage": ...}`` a line); bare
                        filenames resolve against the packaged
                        ``repro_torch/sim/traces/`` directory
======================  =====================================================

A copy of ``repro.sim.scenario``: every field and every built-in scenario
equal to the JAX package's, and its own copy of the packaged trace.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, List

REJOIN_POLICIES = ("respawn", "rejoin", "never")

TRACES_DIR = os.path.join(os.path.dirname(__file__), "traces")


@dataclass(frozen=True)
class ScenarioConfig:
    """One simulated cluster environment (process + node pool + policy)."""

    name: str
    process: str = "bernoulli"          # any name in the repro_torch.sim.processes
                                        # registry (register_process)
    rate_per_hour: float = 0.10         # per-stage failure rate (process base)
    iteration_time_s: float = 300.0     # nominal (unstretched) iteration time
    num_stages: int = 6
    protect_edges: bool = True          # first/last tower stages never fail
    # --- node pool --------------------------------------------------------
    slow_fraction: float = 0.0          # fraction of nodes that are stragglers
    slow_factor: float = 1.0            # straggler iteration-time multiplier
    restart_latency_s: float = 0.0      # node redeploy time after a failure
    bandwidth_Bps: float = float("inf")  # state-transfer bandwidth per node
    rejoin: str = "respawn"             # respawn (fresh node) | rejoin (same
                                        # node returns; a spare fills in) |
                                        # never (failures are departures)
    spare_penalty: float = 1.5          # spare-host slowdown while rejoining
    # --- permanent departures (the elastic-repartitioning outcome) --------
    depart_prob: float = 0.0            # chance a failure is permanent under
                                        # respawn/rejoin ("never" makes it 1)
    regrow_h: float = float("inf")      # hours until replacement capacity
                                        # arrives for a departed slot (inf =
                                        # the slot never comes back)
    # --- process parameters ----------------------------------------------
    weibull_shape: float = 1.5          # >1 = wear-out, <1 = infant mortality
    diurnal_peak_h: float = 14.0        # time-of-day of peak preemption
    diurnal_amplitude: float = 0.8      # 0 = flat, 1 = rate swings to 0..2x
    burst_start_h: float = 8.0          # flash-crowd storm window
    burst_len_h: float = 2.0
    burst_rate_per_hour: float = 1.5    # rate inside the storm window
    trace_path: str = ""                # resolved path for process="trace"

    def validate(self) -> None:
        # deferred import: processes imports ScenarioConfig from this module
        from repro_torch.sim.processes import _PROCESSES
        assert self.process in _PROCESSES, (
            f"unknown process {self.process!r}; available: "
            f"{sorted(_PROCESSES)} (register_process adds plugins)")
        assert self.rejoin in REJOIN_POLICIES, self.rejoin
        assert self.num_stages >= 2, "need at least two pipeline stages"
        assert self.iteration_time_s > 0
        assert 0.0 <= self.depart_prob <= 1.0, self.depart_prob
        assert self.regrow_h > 0, self.regrow_h
        if self.process == "trace":
            assert self.trace_path, "trace scenarios need a trace_path"


_SCENARIOS: Dict[str, ScenarioConfig] = {}


def register_scenario(sc: ScenarioConfig) -> ScenarioConfig:
    if sc.name in _SCENARIOS:
        raise ValueError(f"scenario {sc.name!r} already registered")
    _SCENARIOS[sc.name] = sc
    return sc


def available_scenarios() -> List[str]:
    return sorted(_SCENARIOS)


def resolve_trace_path(path: str) -> str:
    """Resolve a trace file: explicit paths win, bare names fall back to the
    packaged ``repro_torch/sim/traces/`` directory."""
    if os.path.exists(path):
        return path
    packaged = os.path.join(TRACES_DIR, path)
    if os.path.exists(packaged):
        return packaged
    raise FileNotFoundError(
        f"trace file {path!r} not found (also looked in {TRACES_DIR})")


def get_scenario(name: str, **overrides) -> ScenarioConfig:
    """Look up a scenario by name (``trace:<file>`` replays a trace file);
    keyword overrides are applied with ``dataclasses.replace``."""
    if name.startswith("trace:"):
        path = resolve_trace_path(name[len("trace:"):])
        sc = dataclasses.replace(_TRACE_TEMPLATE, name=name, trace_path=path)
    else:
        try:
            sc = _SCENARIOS[name]
        except KeyError:
            raise KeyError(f"unknown scenario {name!r}; available: "
                           f"{available_scenarios()} or trace:<file>") \
                from None
    if overrides:
        sc = dataclasses.replace(sc, **overrides)
    sc.validate()
    return sc


# ---------------------------------------------------------------------------
# built-in scenarios
# ---------------------------------------------------------------------------

register_scenario(ScenarioConfig(
    name="bernoulli",
    process="bernoulli",
    rate_per_hour=0.10,
    # pure legacy compatibility: homogeneous nodes, free recovery — the
    # simulated run is indistinguishable from core.failures.FailureSchedule
))

_PAPER_NODES = dict(restart_latency_s=60.0, bandwidth_Bps=62.5e6)
register_scenario(ScenarioConfig(
    name="paper_5pct", process="bernoulli", rate_per_hour=0.05,
    **_PAPER_NODES))
register_scenario(ScenarioConfig(
    name="paper_10pct", process="bernoulli", rate_per_hour=0.10,
    **_PAPER_NODES))
register_scenario(ScenarioConfig(
    name="paper_16pct", process="bernoulli", rate_per_hour=0.16,
    **_PAPER_NODES))

register_scenario(ScenarioConfig(
    name="spot_diurnal", process="diurnal",
    rate_per_hour=0.12, diurnal_peak_h=14.0, diurnal_amplitude=0.9,
    slow_fraction=0.3, slow_factor=1.6,
    restart_latency_s=120.0, bandwidth_Bps=62.5e6,
    rejoin="rejoin", spare_penalty=1.5))

register_scenario(ScenarioConfig(
    name="flash_crowd", process="flash",
    rate_per_hour=0.02, burst_start_h=8.0, burst_len_h=2.0,
    burst_rate_per_hour=1.5,
    restart_latency_s=90.0, bandwidth_Bps=62.5e6))

register_scenario(ScenarioConfig(
    name="spot_shrink", process="bernoulli",
    rate_per_hour=0.08,
    restart_latency_s=120.0, bandwidth_Bps=62.5e6,
    # every preemption is permanent: the spot node is reclaimed for good,
    # and replacement capacity only arrives after ``regrow_h`` hours —
    # the scenario elastic repartitioning (shrink K -> K-1, grow back on
    # regrow) exists for
    rejoin="never", regrow_h=1.5, spare_penalty=1.6))

register_scenario(ScenarioConfig(
    name="wearout", process="weibull",
    rate_per_hour=0.10, weibull_shape=2.0,
    restart_latency_s=60.0, bandwidth_Bps=62.5e6))

_TRACE_TEMPLATE = ScenarioConfig(
    name="trace", process="trace",
    restart_latency_s=90.0, bandwidth_Bps=62.5e6)
