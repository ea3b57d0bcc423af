"""Elastic repartitioning in the port against the JAX trainer, on the CPU.

A reduced paper-LLaMA cut to 6 layers (d_model 64, fp32) on 4 stages, the
layout (2, 2, 1, 1), trains 12 steps in both packages from JAX's initial
parameters on the same numpy batches, under ``spot_shrink`` with the
overrides ``SHRINK`` and seed 38: each package's own simulator gives a
transient failure of slot 2 at wall 2 (on the uneven 4-stage layout, so the
merge gathers its 2-layer neighbour down to 1 layer), a departure of slot 1
at wall 5 (4 -> 3 stages, (2, 2, 2)) and fresh capacity for it at wall 10
(3 -> 4).  ``spot_shrink`` itself makes every failure a departure
(``rejoin="never"``); the overrides respawn the failed node and depart it
with probability 0.5, so that one run holds both kinds.

``elastic`` runs in windows of 1 and of 8, each against JAX's run of the
same window: the repartition log equal (its costs within 1e-12 relative),
failures, the effective-step trace and dispatches equal, the modelled wall
time within 1e-9 relative (the shrunk layout is paced by its surviving
slots), losses within 1e-4 and recovery errors within 1e-3 relative (the
tolerances of tests/test_torch_trainer.py, which states why), and the final
parameters within 1e-4.  Also: ``adaptive`` with ``elastic`` as its low
policy (its priced departure decisions equal JAX's), the store's re-shard,
``elastic`` equal to ``checkfree`` bit for bit without departures, the
floor of two stages, the partition check of a fused window, and the
launcher.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import (OptimizerConfig as JOpt, RecoveryConfig as JRec,
                          TrainConfig as JTrain)
from repro.configs import get_config as jax_get_config
from repro.core.trainer import Trainer as JTrainer
from repro.core.walltime import WallClockModel as JWall
from repro.data.pipeline import make_batches as jax_make_batches
from repro.models.model import build_model as jax_build_model
from repro.sim import get_scenario as jax_get_scenario
from repro.sim import simulate as jax_simulate
from repro_torch import tree as TR
from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.stages import StagePartition
from repro_torch.core.state import TrainState
from repro_torch.core.trainer import Trainer
from repro_torch.core.walltime import WallClockModel
from repro_torch.core.window import FusedWindow
from repro_torch.data.pipeline import make_batches
from repro_torch.launch import train
from repro_torch.models.model import Model
from repro_torch.optim.adam import init_adam
from repro_torch.recovery import make_strategy
from repro_torch.sim import get_scenario, simulate
from repro_torch.statestore import DiskTier, MemoryTier, StateStore

MINI = dict(name="paper-llama-124m-mini6", num_layers=6, d_model=64,
            num_heads=4, num_kv_heads=4, d_ff=172, vocab_size=512,
            max_seq_len=32, dtype="float32")
STEPS, STAGES, BATCH, SEQ = 12, 4, 4, 32
LOSS_RTOL, RECOVERY_RTOL, PARAM_TOL = 1e-4, 1e-3, 1e-4
SHRINK = dict(rate_per_hour=2.0, regrow_h=0.5, rejoin="respawn",
              depart_prob=0.5, iteration_time_s=300.0)
SEED = 38
STORY = [(2, 2, "fail"), (5, 1, "depart"), (10, 1, "regrow")]
SPECS = WallClockModel().tier_specs()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ElasticForced:
    """A schedule of fixed events with the elastic hooks."""

    def __init__(self, fails, departs=None, regrows=None):
        self._f, self._d, self._r = dict(fails), dict(departs or {}), \
            dict(regrows or {})

    def at(self, step):
        return list(self._f.get(step, []))

    def departed_at(self, step):
        return list(self._d.get(step, []))

    def regrown_at(self, step):
        return list(self._r.get(step, []))


@pytest.fixture
def windows(monkeypatch):
    """Every ``FusedWindow`` made while the test runs, in order: the run's
    first and one more at each re-layout."""
    made = []
    init = FusedWindow.__init__

    def record(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)
    monkeypatch.setattr(FusedWindow, "__init__", record)
    return made


def shrink_schedules(num_stages=STAGES):
    """(JAX's, the port's) simulated spot_shrink schedule of the test."""
    kw = dict(steps=STEPS * 10, seed=SEED, num_stages=num_stages,
              protect_edges=True)
    return (jax_simulate(jax_get_scenario("spot_shrink", **SHRINK), **kw),
            simulate(get_scenario("spot_shrink", **SHRINK), **kw))


def configs(O, R, T, strategy, window, tmp, pkg, **rcfg):
    rcfg = dict(dict(strategy=strategy, num_stages=STAGES,
                     protect_edge_stages=True, checkpoint_every=3,
                     checkpoint_dir=str(tmp / f"{pkg}_ckpt"),
                     store_dir=str(tmp / f"{pkg}_store")), **rcfg)
    return T(global_batch=BATCH, microbatch=BATCH, seq_len=SEQ, steps=STEPS,
             eval_every=100, fuse_window=window,
             optimizer=O(lr=1e-3, total_steps=STEPS, warmup_steps=2),
             recovery=R(**rcfg))


def run_jax(strategy, schedule, tmp, *, window=8, wall=None, **rcfg):
    jcfg = jax_get_config("paper-llama-124m").replace(**MINI)
    trainer = JTrainer(jax_build_model(jcfg),
                       configs(JOpt, JRec, JTrain, strategy, window, tmp,
                               "jax", **rcfg),
                       wall=JWall(model_bytes=8 * jcfg.param_count(),
                                  **(wall or {})),
                       schedule=schedule)
    state, hist = trainer.run(jax_make_batches(jcfg, batch=BATCH, seq=SEQ,
                                               seed=0))
    return trainer, state, hist


def run_port(strategy, schedule, tmp, *, window=8, wall=None, **rcfg):
    jcfg = jax_get_config("paper-llama-124m").replace(**MINI)
    params = params_from_numpy(jax.tree.map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0))),
        device="cpu")
    cfg = get_config("paper-llama-124m").replace(**MINI)
    trainer = Trainer(Model(cfg, device="cpu", weights=False),
                      configs(OptimizerConfig, RecoveryConfig, TrainConfig,
                              strategy, window, tmp, f"torch{window}",
                              **rcfg),
                      wall=WallClockModel(model_bytes=8 * cfg.param_count(),
                                          **(wall or {})),
                      schedule=schedule)
    state, hist = trainer.run(make_batches(cfg, batch=BATCH, seq=SEQ, seed=0),
                              params=params)
    return trainer, state, hist


def check_same_run(jtrainer, jstate, jhist, trainer, state, hist):
    assert [r[:5] for r in trainer.repartition_log] == \
        [r[:5] for r in jtrainer.repartition_log]
    np.testing.assert_allclose([r[5] for r in trainer.repartition_log],
                               [r[5] for r in jtrainer.repartition_log],
                               rtol=1e-12)
    assert [tuple(f) for f in hist.failures] == \
        [tuple(f) for f in jhist.failures]
    assert hist.steps == jhist.steps and hist.wall_iters == jhist.wall_iters
    assert hist.dispatches == jhist.dispatches
    np.testing.assert_allclose(hist.wall_time, jhist.wall_time, rtol=1e-9)
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    assert [s for s, _ in hist.recovery_errors] == \
        [s for s, _ in jhist.recovery_errors]
    np.testing.assert_allclose([e for _, e in hist.recovery_errors],
                               [e for _, e in jhist.recovery_errors],
                               rtol=RECOVERY_RTOL)
    assert trainer._slots == jtrainer._slots
    assert trainer.part.layer_counts == jtrainer.part.layer_counts
    for a, b in zip(jax.tree.leaves(params_to_numpy(state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=PARAM_TOL)


@pytest.mark.parametrize("window", [1, 8])
def test_elastic_matches_jax_through_a_shrink_and_a_grow(window, tmp_path,
                                                         windows):
    jsched, sched = shrink_schedules()
    story = sorted([(w, s, "fail") for w in range(STEPS) for s in sched.at(w)
                    if s not in sched.departed_at(w)] +
                   [(w, s, "depart") for w in range(STEPS)
                    for s in sched.departed_at(w)] +
                   [(w, s, "regrow") for w in range(STEPS)
                    for s in sched.regrown_at(w)])
    assert story == STORY
    jtrainer, jstate, jhist = run_jax("elastic", jsched, tmp_path,
                                      window=window)
    trainer, state, hist = run_port("elastic", sched, tmp_path, window=window)
    check_same_run(jtrainer, jstate, jhist, trainer, state, hist)
    assert [r[:4] for r in trainer.repartition_log] == \
        [(5, "shrink", 4, 3), (10, "grow", 3, 4)]
    assert hist.failures == [(2, 2), (5, 1)]
    assert state.effective_step == STEPS and len(hist.recovery_errors) == 2
    # one window per layout epoch, each for its own cut
    assert [w.part.num_stages for w in windows] == [4, 3, 4]
    assert [w.width - w.part.num_stages for w in windows] == [7] * 3
    assert trainer.window is windows[-1]
    assert all(w.graph is None for w in windows)   # CPU: no capture
    if window > 1:
        assert hist.dispatches < hist.wall_iters
        assert trainer.dispatched_buckets == jtrainer.dispatched_buckets


@pytest.mark.parametrize("link", ["fast", "slow"])
def test_adaptive_with_elastic_low_decides_as_jax(link, tmp_path):
    """``adaptive`` prices each departure (re-layout against staying
    degraded on a spare): its decisions, and the run, equal JAX's.  Over a
    slow link (1 kB/s) the re-layout costs more than limping on, so the
    departure is declined and recovered in place."""
    jsched, sched = shrink_schedules()
    kw = dict(adaptive_low="elastic", adaptive_high="checkfree",
              adaptive_window=8,
              wall=dict(link_bandwidth_Bps=1e3) if link == "slow" else None)
    jtrainer, jstate, jhist = run_jax("adaptive", jsched, tmp_path, **kw)
    trainer, state, hist = run_port("adaptive", sched, tmp_path, **kw)
    decisions = trainer.strategy.repartition_decisions
    jdecisions = jtrainer.strategy.repartition_decisions
    assert [d[1] for d in decisions] == [link == "fast"]
    assert len(trainer.repartition_log) == (2 if link == "fast" else 0)
    assert [d[:2] for d in decisions] == [d[:2] for d in jdecisions]
    np.testing.assert_allclose([d[2:] for d in decisions],
                               [d[2:] for d in jdecisions], rtol=1e-12)
    assert trainer.strategy.switches == jtrainer.strategy.switches
    check_same_run(jtrainer, jstate, jhist, trainer, state, hist)


def test_adaptive_with_checkpoint_children_repartitions_as_jax(tmp_path):
    """As in JAX, ``adaptive`` advertises repartitioning whatever its
    children: with ``checkfree`` and ``checkpoint`` it shrinks and grows
    where JAX's does."""
    jsched, sched = shrink_schedules()
    jtrainer, jstate, jhist = run_jax("adaptive", jsched, tmp_path)
    trainer, state, hist = run_port("adaptive", sched, tmp_path)
    assert trainer.strategy.recover_by_repartition
    assert [d[:2] for d in trainer.strategy.repartition_decisions] == \
        [d[:2] for d in jtrainer.strategy.repartition_decisions]
    check_same_run(jtrainer, jstate, jhist, trainer, state, hist)


def test_elastic_without_departures_equals_checkfree(tmp_path):
    """No departure: the same run as ``checkfree``, bit for bit."""
    fails = {3: [1], 6: [2]}
    _, se, he = run_port("elastic", ElasticForced(fails), tmp_path / "e")
    _, sc, hc = run_port("checkfree", ElasticForced(fails), tmp_path / "c")
    assert he.loss == hc.loss and he.failures == hc.failures
    assert he.recovery_errors == hc.recovery_errors
    assert he.wall_time == hc.wall_time
    for a, b in zip(TR.leaves(se.params), TR.leaves(sc.params)):
        assert torch.equal(a, b)


def test_elastic_never_shrinks_below_two_stages(tmp_path):
    """3 -> 2 once; the later departures are recovered in place."""
    sched = ElasticForced({1: [1], 3: [0], 5: [1]},
                          departs={1: [1], 3: [0], 5: [1]})
    trainer, state, hist = run_port("elastic", sched, tmp_path,
                                    num_stages=3)
    assert [r[1:4] for r in trainer.repartition_log] == [("shrink", 3, 2)]
    assert trainer.part.num_stages == 2 and trainer._slots == [0, 2]
    assert hist.failures == [(1, 1), (3, 0)]   # slot 1 departed before wall 5
    assert state.effective_step == STEPS and all(np.isfinite(hist.loss))


def test_a_window_refuses_another_partition(tmp_path, windows):
    """A window belongs to the cut its graph sums the omegas over: after a
    re-layout the old one refuses a dispatch under the new partition."""
    sched = ElasticForced({3: [1]}, departs={3: [1]})
    trainer, state, _ = run_port("elastic", sched, tmp_path)
    old, new = windows
    assert old.part.num_stages == 4 and new.part is trainer.part
    stacked = next(make_batches(trainer.model.cfg, batch=BATCH, seq=SEQ,
                                seed=0))
    stacked = {k: np.asarray(v)[None] for k, v in stacked.items()}
    with pytest.raises(AssertionError, match="another cut"):
        old.dispatch(state, stacked, part=trainer.part)


# ---------------------------------------------------------------------------
# the store's re-shard after a layout change
# ---------------------------------------------------------------------------

def test_store_reshard_drops_stale_layout(tmp_path):
    store = StateStore([MemoryTier(SPECS["mem"]),
                        DiskTier(SPECS["disk"], str(tmp_path))])
    for step in (1, 2):
        for sid in ("stage00", "stage01", "stage02", "stage03"):
            store.put({"w": torch.full((2,), float(step))}, step=step,
                      shard_id=sid, tier="mem", host=0)
            store.put({"w": torch.full((2,), float(step))}, step=step,
                      shard_id=sid, tier="disk")
    store.reshard({"stage00": {"w": torch.arange(3.0)},
                   "stage01": {"w": torch.arange(3.0) + 10},
                   "stage02": {"w": torch.arange(3.0) + 20}},
                  step=5, hosts={"stage00": 1, "stage01": 2, "stage02": 0})
    # the old 4-shard layout is gone everywhere; only the fastest tier reseeds
    assert store.tier("mem").shard_ids() == ["stage00", "stage01", "stage02"]
    assert store.tier("mem").steps("stage00") == [5]
    assert store.tier("disk").shard_ids() == []
    for i, sid in enumerate(("stage00", "stage01", "stage02")):
        res = store.restore(sid, {"w": torch.zeros(3)})
        assert res.step == 5
        assert torch.equal(res.tree["w"], torch.arange(3.0) + 10 * i)
    store.close()


def test_strategy_on_layout_change_reshards(tmp_path):
    cfg = get_config("paper-llama-124m").replace(**MINI)
    strat = make_strategy(RecoveryConfig(strategy="tiered_ckpt",
                                         num_stages=4,
                                         store_dir=str(tmp_path)))
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    state = TrainState(params, init_adam(params))
    old = StagePartition(cfg, 4)
    strat.bind(old)
    strat._save_shards(state, ["mem"])
    assert strat.store.tier("mem").shard_ids() == [
        "stage00", "stage01", "stage02", "stage03"]
    new = StagePartition(cfg, 3)
    state = strat.on_layout_change(state, old, new)
    assert strat.part is new
    assert strat.store.tier("mem").shard_ids() == [
        "stage00", "stage01", "stage02"]
    # the restored shard holds the *new* bounds' layers
    res = strat.store.restore("stage01", strat._shard_tree(state, 1))
    for a, b in zip(TR.leaves(res.tree["params"]),
                    TR.leaves(new.get_stage(state.params, 1))):
        assert torch.equal(a, b)
    strat.on_run_end()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

class Recording(Trainer):
    """The launcher's trainers, kept for the test to read."""
    seen = []

    def __init__(self, model, tcfg, **kw):
        super().__init__(model, tcfg, **kw)
        Recording.seen.append(self)


def test_train_cli_elastic_spot_shrink_on_cpu(monkeypatch):
    """``--scenario spot_shrink --strategy elastic``: the simulated
    departure of slot 2 at wall 5 shrinks the pipeline 4 -> 3, its regrow
    at wall 17 grows it back, and the run completes in fused windows."""
    monkeypatch.setattr(train, "Trainer", Recording)
    monkeypatch.setattr(Recording, "seen", [])
    hist = train.main(["--scenario", "spot_shrink", "--strategy", "elastic",
                       "--reduced", "--layers", "6", "--stages", "4",
                       "--device", "cpu", "--steps", "20", "--seq", "16",
                       "--batch", "2", "--quiet"])
    [trainer] = Recording.seen
    assert hist.steps == list(range(1, 21)) and all(np.isfinite(hist.loss))
    assert hist.failures == [(5, 2)]
    assert [r[:4] for r in trainer.repartition_log] == [
        (5, "shrink", 4, 3), (17, "grow", 3, 4)]
    assert trainer.schedule.result.scenario == get_scenario(
        "spot_shrink", num_stages=4)
    assert hist.dispatches < hist.wall_iters


def test_train_cli_depart_prob_needs_a_scenario(capsys):
    for flag in (["--depart-prob", "0.2"], ["--regrow-h", "1.0"]):
        with pytest.raises(SystemExit):
            train.main(["--reduced", "--device", "cpu", *flag])
        assert "need --scenario" in capsys.readouterr().err


def test_train_cli_overrides_reach_the_simulator(monkeypatch):
    monkeypatch.setattr(train, "Trainer", Recording)
    monkeypatch.setattr(Recording, "seen", [])
    train.main(["--scenario", "spot_shrink", "--depart-prob", "0.5",
                "--regrow-h", "0.25", "--strategy", "elastic", "--reduced",
                "--layers", "4", "--stages", "4", "--device", "cpu",
                "--steps", "2", "--seq", "16", "--batch", "2", "--quiet"])
    [trainer] = Recording.seen
    sc = trainer.schedule.result.scenario
    assert (sc.depart_prob, sc.regrow_h, sc.num_stages) == (0.5, 0.25, 4)
    assert dataclasses.replace(sc, depart_prob=0.0, regrow_h=1.5,
                               num_stages=6) == get_scenario("spot_shrink")
