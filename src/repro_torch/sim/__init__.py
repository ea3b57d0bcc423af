"""Event-driven cluster churn simulator: the port's copy of ``repro.sim``.

The paper's setting is transient node churn on decentralized/spot
clusters; this package simulates that environment so recovery policies can
be priced against realistic failure dynamics instead of a single
per-iteration coin.  It is numpy only, with the JAX package's generator
calls in the same order, so a scenario, seed and stage count give the same
events, factors and overheads in both packages.

    from repro_torch.sim import simulate

    schedule = simulate("spot_diurnal", steps=4000, seed=42)
    trainer = Trainer(model, tcfg, schedule=schedule)

``simulate`` returns a :class:`SimFailureSchedule`: drop-in compatible with
:class:`repro_torch.core.failures.FailureSchedule` (bit-identical under the
``bernoulli`` scenario for matched parameters), with the per-event
wall-clock hooks and the departure/regrow hooks the trainer uses when
present.
"""
from repro_torch.sim.adapters import SimFailureSchedule, simulate  # noqa: F401
from repro_torch.sim.cluster import Cluster, SimResult  # noqa: F401
from repro_torch.sim.node import Node  # noqa: F401
from repro_torch.sim.processes import (FailureProcess,  # noqa: F401
                                       HazardProcess, available_processes,
                                       load_trace, make_process,
                                       register_process)
from repro_torch.sim.scenario import (ScenarioConfig,  # noqa: F401
                                      available_scenarios, get_scenario,
                                      register_scenario, resolve_trace_path)
