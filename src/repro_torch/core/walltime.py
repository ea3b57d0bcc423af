"""Analytic wall-clock model (Table 2 analog).

Wall-clock is modelled, not measured, because training runs on one host:
iteration times are either calibrated from the measured single-host step time
or taken from the paper's reported values; per-strategy overheads follow the
paper's measurements (redundant computation = 151.0/91.3 = 1.654x iteration
time; CheckFree stage recovery ~= 30 s; checkpoint saves cost
bytes/bandwidth against the external storage; rollback repeats lost
iterations).

A copy of ``repro.core.walltime``.  The model itself only holds timing
*constants*; how they combine per policy lives on each
:class:`~repro_torch.recovery.base.RecoveryStrategy` (``iteration_cost`` /
``failure_cost``).  The string-keyed methods below delegate to the port's
registry, for pricing a policy without building a trainer.

These constants are the *homogeneous-cluster* baseline.  A schedule may
stretch iterations and add per-event recovery overheads on top of them
through its optional ``iteration_factor`` / ``failure_overhead`` hooks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class TierSpec:
    """Pricing description of one storage tier (TierCheck's tier model).

    The constants live here, next to the other timing constants, so that the
    statestore tiers (to come in the port) price reads and writes as the
    analytic model does.
    """

    name: str
    kind: str                    # "memory" | "disk" | "remote"
    capacity_bytes: float
    latency_s: float             # per-operation fixed cost
    bandwidth_Bps: float         # sustained transfer rate

    def read_time_s(self, nbytes: float) -> float:
        if self.bandwidth_Bps <= 0 or self.bandwidth_Bps == float("inf"):
            return self.latency_s
        return self.latency_s + nbytes / self.bandwidth_Bps

    def write_time_s(self, nbytes: float) -> float:
        return self.read_time_s(nbytes)


@dataclass
class WallClockModel:
    iter_time_s: float = 91.3            # paper Table 2 (medium model)
    redundant_factor: float = 151.0 / 91.3
    recovery_time_s: float = 30.0        # paper §5.1 (CheckFree stage reinit)
    promote_time_s: float = 5.0          # promote redundant copy: near-instant
    ckpt_bandwidth_Bps: float = 62.5e6   # 500 Mb/s to non-faulty storage (fn.2)
    restart_overhead_s: float = 60.0     # checkpoint rollback: redeploy + load
    model_bytes: int = int(2e9)          # serialized model+opt (500M fp32 ~ 8GB/4)
    # --- statestore tiers (TierCheck's memory -> local disk -> remote) ------
    mem_bandwidth_Bps: float = 12.8e9    # peer host memory over the fabric
    mem_latency_s: float = 1e-4
    mem_capacity_bytes: float = 16e9
    disk_bandwidth_Bps: float = 2e9      # local NVMe
    disk_latency_s: float = 5e-3
    disk_capacity_bytes: float = 1e12
    remote_latency_s: float = 0.2        # object-store round trip
    remote_capacity_bytes: float = float("inf")
    # --- elastic re-layout (peer-to-peer state movement over the fabric) ----
    link_bandwidth_Bps: float = 12.8e9   # inter-host link, same as hot tier
    relayout_latency_s: float = 2.0      # barrier + re-plan before moving

    def tier_specs(self) -> Dict[str, TierSpec]:
        """The default three-tier hierarchy, fastest first.  The remote tier
        reuses ``ckpt_bandwidth_Bps`` — the paper's 500 Mb/s link to
        "non-faulty storage" (fn. 2), what the old flat checkpoint pricing
        charged — so porting the baseline onto tiers only adds the remote
        round-trip latency (~0.6% of a full-model save)."""
        return {
            "mem": TierSpec("mem", "memory", self.mem_capacity_bytes,
                            self.mem_latency_s, self.mem_bandwidth_Bps),
            "disk": TierSpec("disk", "disk", self.disk_capacity_bytes,
                             self.disk_latency_s, self.disk_bandwidth_Bps),
            "remote": TierSpec("remote", "remote", self.remote_capacity_bytes,
                               self.remote_latency_s, self.ckpt_bandwidth_Bps),
        }

    def ckpt_save_time_s(self) -> float:
        """Full-model serialize to the remote ("non-faulty") tier."""
        return self.tier_specs()["remote"].write_time_s(self.model_bytes)

    def stage_bytes(self, num_stages: int) -> float:
        """Serialized bytes of one pipeline stage (model+opt split evenly);
        the cluster simulator prices recovery transfers with this against
        each replacement node's bandwidth."""
        return self.model_bytes / max(num_stages, 1)

    def layer_bytes(self, num_layers: int) -> float:
        """Serialized bytes of one transformer block (tower split evenly);
        the elastic re-layout moves whole blocks between surviving hosts."""
        return self.model_bytes / max(num_layers, 1)

    def relayout_time_s(self, nbytes: float) -> float:
        """One-time cost of an elastic re-layout that moves ``nbytes`` of
        stage state between surviving hosts: a fixed re-plan barrier plus
        bytes over the inter-host link.  Charged once per layout change
        (shrink or grow), never on the steady-state path."""
        if self.link_bandwidth_Bps <= 0 or \
                self.link_bandwidth_Bps == float("inf"):
            return self.relayout_latency_s
        return self.relayout_latency_s + nbytes / self.link_bandwidth_Bps

    # ---- legacy string-dispatch shim (delegates to the registry) --------
    def _strategy(self, name: str, ckpt_every: int = 100):
        from repro_torch.config import RecoveryConfig
        from repro_torch.recovery import make_strategy
        return make_strategy(
            RecoveryConfig(strategy=name, checkpoint_every=ckpt_every),
            wall=self)

    def iteration_cost(self, strategy: str, ckpt_every: int = 100) -> float:
        """Modelled seconds per wall iteration under ``strategy``."""
        return self._strategy(strategy, ckpt_every).iteration_cost()

    def failure_cost(self, strategy: str) -> float:
        """Extra seconds per failure event (excluding rollback re-training,
        which the trainer accounts for by replaying iterations)."""
        return self._strategy(strategy).failure_cost()
