"""The port's cluster simulator (``repro_torch.sim``) against ``repro.sim``.

The simulator is numpy in both packages, with the same generator calls in
the same order, so everything it gives is held equal to JAX's with
tolerance 0: for every registered scenario and the packaged trace, at
three seeds and 4 and 6 stages over 500 steps, the events and the
suppressed candidates, ``at``, ``departed_at``, ``regrown_at``, the
iteration factors (also over sets of surviving slots), the failure
overheads with and without the bytes a strategy shipped, the observed
rate, ``len``, ``summary()`` and every array of the result.  Every field of
every built-in scenario equals JAX's.  Then the behaviour cases of
tests/test_sim.py and tests/test_elastic.py's simulator section on the
port alone: Bernoulli bit parity with the port's ``FailureSchedule``,
trace replay, the registry, overrides and validation, a custom process,
node-dependent pricing, departures and regrows.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro import sim as J
from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.failures import FailureSchedule
from repro_torch.core.trainer import Trainer
from repro_torch.core.walltime import WallClockModel
from repro_torch.models.model import Model
from repro_torch.sim import (HazardProcess, ScenarioConfig,
                             available_processes, available_scenarios,
                             get_scenario, load_trace,
                             register_process, register_scenario,
                             resolve_trace_path, simulate)
from repro_torch.sim import scenario as scenario_mod

STEPS = 500
SCENARIOS = available_scenarios() + ["trace:spot_demo.jsonl"]
BUILTIN = ["bernoulli", "flash_crowd", "paper_10pct", "paper_16pct",
           "paper_5pct", "spot_diurnal", "spot_shrink", "wearout"]


def pairs(sched):
    return [(e.step, e.stage) for e in sched]


def slot_sets(k):
    return [list(range(k)), list(range(k - 1)), list(range(1, k)),
            [0, k - 1], [k // 2], []]


def check_equal_results(a, b):
    """Every array and record of two SimResults, exactly."""
    assert pairs(a.events) == pairs(b.events)
    assert pairs(a.suppressed) == pairs(b.suppressed)
    assert a.overheads == b.overheads and a.event_costs == b.event_costs
    assert a.node_log == b.node_log
    assert a.departures == b.departures and a.regrows == b.regrows
    np.testing.assert_array_equal(a.iter_factors, b.iter_factors)
    np.testing.assert_array_equal(a.times_h, b.times_h)
    np.testing.assert_array_equal(a.stage_slowdowns, b.stage_slowdowns)
    assert a.total_hours == b.total_hours


@pytest.mark.parametrize("k", [4, 6])
@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("name", SCENARIOS)
def test_simulator_equals_jax(name, seed, k):
    ours = simulate(name, steps=STEPS, seed=seed, num_stages=k)
    theirs = J.simulate(name, steps=STEPS, seed=seed, num_stages=k)
    check_equal_results(ours.result, theirs.result)
    assert len(ours) == len(theirs) and ours.summary() == theirs.summary()
    for step in range(STEPS + 2):
        assert ours.at(step) == theirs.at(step)
        assert ours.departed_at(step) == theirs.departed_at(step)
        assert ours.regrown_at(step) == theirs.regrown_at(step)
        assert ours.iteration_factor(step) == theirs.iteration_factor(step)
        assert ours.observed_rate(step) == theirs.observed_rate(step)
        for slots in slot_sets(k):
            assert ours.iteration_factor_active(step, slots) == \
                theirs.iteration_factor_active(step, slots)
    for step, stage in pairs(theirs.events) + [(1, 1), (10 ** 9, 0)]:
        for nbytes in (None, 1.0, 3.5e8, 1e12):
            args = (step, stage) if nbytes is None else (step, stage, nbytes)
            assert ours.failure_overhead(*args) == \
                theirs.failure_overhead(*args)


def test_scenarios_equal_jax_field_by_field():
    jax_names = [n for n in J.available_scenarios()
                 if not n.startswith("test_")]
    assert [n for n in available_scenarios()
            if not n.startswith("test_")] == jax_names == BUILTIN
    fields = [f.name for f in dataclasses.fields(ScenarioConfig)]
    assert fields == [f.name for f in dataclasses.fields(J.ScenarioConfig)]
    for name in BUILTIN + ["trace:spot_demo.jsonl"]:
        ours, theirs = get_scenario(name), J.get_scenario(name)
        for f in fields:
            if f == "trace_path":
                continue
            assert getattr(ours, f) == getattr(theirs, f), (name, f)
    assert scenario_mod.REJOIN_POLICIES == J.scenario.REJOIN_POLICIES
    builtin = {"bernoulli", "poisson", "diurnal", "flash", "weibull", "trace"}
    assert builtin <= set(available_processes())
    assert builtin <= set(J.available_processes())


def test_packaged_trace_is_the_port_own_copy():
    path = resolve_trace_path("spot_demo.jsonl")
    assert "repro_torch" in path and path != J.resolve_trace_path(
        "spot_demo.jsonl")
    with open(path) as a, open(J.resolve_trace_path("spot_demo.jsonl")) as b:
        assert a.read() == b.read()
    events = load_trace(path)
    assert len(events) > 10 and events == sorted(events, key=lambda e: e[0])
    assert events == J.load_trace(J.resolve_trace_path("spot_demo.jsonl"))


# ---------------------------------------------------------------------------
# Bernoulli-adapter parity with the port's FailureSchedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("rate", [0.05, 0.10, 0.16])
def test_bernoulli_bit_parity_with_failure_schedule(seed, rate):
    legacy = FailureSchedule(rate_per_hour=rate, iteration_time_s=300.0,
                             num_stages=6, steps=1500, seed=seed,
                             protect_edges=True)
    sim = simulate(get_scenario("bernoulli", rate_per_hour=rate,
                                iteration_time_s=300.0),
                   steps=1500, seed=seed, num_stages=6, protect_edges=True)
    assert sim.events == legacy.events and len(sim) == len(legacy)
    assert all(sim.at(s) == legacy.at(s) for s in range(1500))
    # the pure-compat scenario adds no node costs
    assert all(sim.iteration_factor(s) == 1.0 for s in range(1500))
    assert all(sim.failure_overhead(e.step, e.stage) == 0.0
               for e in sim.events)


def test_bernoulli_parity_without_edge_protection():
    legacy = FailureSchedule(rate_per_hour=0.16, iteration_time_s=300.0,
                             num_stages=5, steps=800, seed=3,
                             protect_edges=False)
    sim = simulate(get_scenario("bernoulli", rate_per_hour=0.16,
                                iteration_time_s=300.0),
                   steps=800, seed=3, num_stages=5, protect_edges=False)
    assert sim.events == legacy.events


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

def test_trace_events_land_on_their_iteration(tmp_path):
    trace = tmp_path / "t.jsonl"
    trace.write_text('# comment\n'
                     '{"t_h": 0.09, "stage": 1}\n'
                     '{"t_h": 0.26, "stage": 2}\n'
                     '{"t_h": 0.0, "stage": 0}\n')  # protected -> skipped
    sc = get_scenario(f"trace:{trace}", iteration_time_s=300.0,
                      num_stages=4, protect_edges=True,
                      restart_latency_s=0.0, bandwidth_Bps=float("inf"))
    sim = simulate(sc, steps=12, seed=0)
    # dt = 300 s = 1/12 h: t=0.09 -> step 1, t=0.26 -> step 3
    assert pairs(sim.events) == [(1, 1), (3, 2)]


def test_trace_bad_line_raises(tmp_path):
    trace = tmp_path / "bad.jsonl"
    trace.write_text('{"t_h": "not-a-number and no stage"}\n')
    with pytest.raises(ValueError, match="bad trace line"):
        simulate(f"trace:{trace}", steps=4, seed=0)


def test_adjacency_suppressed_trace_events_are_recorded(tmp_path):
    trace = tmp_path / "t.jsonl"
    trace.write_text('{"t_h": 0.09, "stage": 1}\n'
                     '{"t_h": 0.10, "stage": 2}\n')
    sim = simulate(get_scenario(f"trace:{trace}", iteration_time_s=300.0,
                                num_stages=4), steps=12, seed=0)
    assert pairs(sim.events) == [(1, 1)]
    assert pairs(sim.result.suppressed) == [(1, 2)]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_unknown_scenario_and_missing_trace_raise():
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("nope")
    with pytest.raises(FileNotFoundError):
        get_scenario("trace:does_not_exist.jsonl")


def test_scenario_overrides_and_validation():
    sc = get_scenario("spot_diurnal", num_stages=8, rate_per_hour=0.5)
    assert sc.num_stages == 8 and sc.rate_per_hour == 0.5
    with pytest.raises(AssertionError):
        get_scenario("bernoulli", rejoin="teleport")
    with pytest.raises(AssertionError, match="unknown process"):
        get_scenario("bernoulli", process="lunar-not-registered")
    with pytest.raises(AssertionError):
        get_scenario("spot_shrink", depart_prob=1.5)
    with pytest.raises(AssertionError):
        get_scenario("spot_shrink", regrow_h=0.0)
    with pytest.raises(ValueError, match="already registered"):
        register_scenario(get_scenario("bernoulli"))


def test_custom_process_plugin_roundtrip():
    """Subclass + register_process is all a plugin needs for validate(),
    get_scenario() and simulate() to take it."""
    class AlwaysStormy(HazardProcess):
        def rate_at(self, t_h, node):
            return 50.0

    register_process("torch_test_stormy", AlwaysStormy)
    register_process("torch_test_stormy", AlwaysStormy)     # idempotent
    with pytest.raises(ValueError, match="already registered"):
        register_process("torch_test_stormy", HazardProcess)
    register_scenario(ScenarioConfig(name="torch_test_stormy_world",
                                     process="torch_test_stormy"))
    sim = simulate("torch_test_stormy_world", steps=50, seed=0)
    assert len(sim) > 0


# ---------------------------------------------------------------------------
# node-dependent wall-clock
# ---------------------------------------------------------------------------

def test_respawn_overhead_prices_restart_plus_transfer():
    wall = WallClockModel(model_bytes=int(4e8))
    sc = get_scenario("bernoulli", rate_per_hour=3.0, iteration_time_s=600.0,
                      restart_latency_s=45.0, bandwidth_Bps=1e6)
    sim = simulate(sc, steps=300, seed=0, num_stages=4, wall=wall)
    assert len(sim) > 0
    expected = 45.0 + wall.stage_bytes(4) / 1e6
    for e in sim.events:
        assert sim.failure_overhead(e.step, e.stage) == pytest.approx(expected)


def test_failure_overhead_reprices_with_actual_bytes():
    sched = simulate("paper_10pct", steps=400, seed=7, num_stages=6,
                     protect_edges=False)
    ev = sched.events[0]
    default = sched.failure_overhead(ev.step, ev.stage)
    tiny = sched.failure_overhead(ev.step, ev.stage, 1.0)
    big = sched.failure_overhead(ev.step, ev.stage, 1e12)
    assert tiny < default < big
    assert sched.failure_overhead(10 ** 9, 0) == 0.0
    assert sched.failure_overhead(10 ** 9, 0, 123.0) == 0.0


def test_stragglers_stretch_every_iteration():
    sim = simulate(get_scenario("bernoulli", slow_fraction=1.0,
                                slow_factor=2.5), steps=50, seed=0)
    assert all(sim.iteration_factor(s) == 2.5 for s in range(50))


def test_rejoin_policy_runs_on_a_spare_then_rejoins(tmp_path):
    trace = tmp_path / "t.jsonl"
    trace.write_text('{"t_h": 0.09, "stage": 1}\n')
    sc = get_scenario(f"trace:{trace}", iteration_time_s=300.0, num_stages=4,
                      rejoin="rejoin", spare_penalty=2.0,
                      restart_latency_s=1200.0, bandwidth_Bps=1e8)
    wall = WallClockModel(model_bytes=int(4e8))
    sim = simulate(sc, steps=30, seed=0, wall=wall)
    assert pairs(sim.events) == [(1, 1)]
    # only the transfer to the spare is charged per event; the restart is
    # paid through stretched iterations until the node rejoins
    assert sim.failure_overhead(1, 1) == pytest.approx(
        wall.stage_bytes(4) / 1e8)
    assert sim.iteration_factor(1) == 1.0 and sim.iteration_factor(2) == 2.0
    rejoin = [s for (kind, s, _, _) in sim.result.node_log if kind == "rejoin"]
    assert rejoin and all(sim.iteration_factor(s) == 1.0
                          for s in range(rejoin[0], 30))


def test_observed_rate_tracks_trailing_window():
    sim = simulate("bernoulli", steps=200, seed=0, rate_window=10)
    assert sim.observed_rate(0) == 0.0
    fails_in = sum(1 for e in sim.events if 40 <= e.step < 50)
    assert sim.observed_rate(50) == pytest.approx(fails_in / 10.0)


# ---------------------------------------------------------------------------
# permanent departures and regrows
# ---------------------------------------------------------------------------

def test_departures_and_regrows_flow_through_adapter():
    sched = simulate("spot_shrink", steps=400, seed=0, num_stages=4)
    deps, regs = sched.result.departures, sched.result.regrows
    assert deps and regs
    for step, stage in deps:
        assert stage in sched.at(step) and stage in sched.departed_at(step)
        # a departed slot cannot fail again until it regrows
        back = next((rs for rs, rg in regs if rg == stage and rs > step),
                    sched.result.steps)
        assert all(stage not in sched.at(s) for s in range(step + 1, back))
        assert sched.failure_overhead(step, stage) == 0.0
    for step, stage in regs:
        assert stage in sched.regrown_at(step)
    step0, stage0 = deps[0]
    assert math.isnan(sched.result.stage_slowdowns[step0 + 1, stage0])


def test_iteration_factor_active_skips_departed_slots():
    sched = simulate("spot_shrink", steps=400, seed=0, num_stages=4)
    step, stage = sched.result.departures[0]
    survivors = [s for s in range(4) if s != stage]
    penalty = sched.result.scenario.spare_penalty
    assert sched.iteration_factor(step + 1) == pytest.approx(penalty)
    assert sched.iteration_factor_active(step + 1, survivors) < penalty
    assert sched.iteration_factor_active(step + 1, list(range(4))) == \
        pytest.approx(penalty)


def test_depart_prob_zero_is_bit_identical_to_the_base_scenario():
    base = get_scenario("spot_diurnal")
    knobbed = dataclasses.replace(base, depart_prob=0.0, regrow_h=7.5)
    a = simulate(base, steps=800, seed=7, num_stages=5)
    b = simulate(knobbed, steps=800, seed=7, num_stages=5)
    assert a.result.events == b.result.events
    assert a.result.node_log == b.result.node_log
    assert not a.result.departures and not b.result.departures


def test_depart_prob_splits_outcomes():
    sched = simulate(get_scenario("spot_diurnal", depart_prob=0.5,
                                  regrow_h=1.0),
                     steps=3000, seed=1, num_stages=6)
    kinds = {k for k, *_ in sched.result.node_log}
    assert "depart" in kinds and "fail" in kinds


# ---------------------------------------------------------------------------
# the trainer builds its schedule from the config's scenario
# ---------------------------------------------------------------------------

def test_trainer_builds_schedule_from_config_scenario():
    cfg = get_config("paper-llama-124m").replace(
        num_layers=4, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
        vocab_size=128, max_seq_len=32, dtype="float32")
    tcfg = TrainConfig(global_batch=4, microbatch=4, seq_len=32, steps=3,
                       optimizer=OptimizerConfig(total_steps=3),
                       recovery=RecoveryConfig(strategy="checkfree",
                                               num_stages=4,
                                               scenario="spot_diurnal",
                                               seed=5))
    trainer = Trainer(Model(cfg, device="cpu", weights=False), tcfg)
    ref = simulate("spot_diurnal", steps=30, seed=5, num_stages=4,
                   protect_edges=True, wall=trainer.wall)
    theirs = J.simulate("spot_diurnal", steps=30, seed=5, num_stages=4,
                        protect_edges=True)
    assert trainer.schedule.events == ref.events
    assert pairs(trainer.schedule.events) == pairs(theirs.events)
    assert isinstance(trainer.schedule.iteration_factor(0), float)
