"""The strategies that snapshot or restore state (``checkpoint``,
``tiered_ckpt``, ``neighbor``, ``adaptive``) on the port's pipeline backend,
on 4 gloo ranks of the CPU, against the JAX ``Trainer`` at ``fuse_window=1``
and the port's host trainer.

The 16-step runs of tests/test_torch_trainer.py (its model, data, JAX
initial parameters and tolerances, stated there: losses 1e-4 relative,
recovery errors 1e-3, NaN where a rollback leaves JAX's NaN) under the
schedules of tests/test_torch_trainer_ckpt.py (a restart before the first
save, rollbacks, two stages lost at once; ``adaptive`` switching under
``Calm`` and ``Stormy``) and tests/test_torch_trainer_store.py's ``CASES``.
The failures, wall iterations, effective-step trace, ``restore_log`` and
``adaptive``'s switches must be equal, and every rank's History equal to
rank 0's.  One run more corrupts rank 2's newest checkpoint just before a
rollback (``statestore.faults``): every rank then goes back to the same
earlier save, as the JAX trainer and the port's host trainer do with their
one checkpoint corrupted alike (each through its own package's
``statestore.faults``).  ``adaptive`` also runs in windows of up to 4.

One spawn runs every spmd run; the JAX and host runs are in this process.
The ranks import this module, which imports no JAX: the model, data and
schedules are written out here as tests/test_torch_trainer.py has them.
"""
import importlib
import math
import os
import sys

import numpy as np
import pytest

from repro_torch import tree as TR
from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.trainer import Trainer
from repro_torch.core.walltime import WallClockModel
from repro_torch.data.pipeline import SyntheticLM, make_batches
from repro_torch.launch.mesh import spawn_stages
from repro_torch.models.model import Model

# tests/test_torch_trainer.py's run
MINI = dict(name="paper-llama-124m-mini", num_layers=8, d_model=128,
            num_heads=4, num_kv_heads=4, d_ff=344, vocab_size=512,
            max_seq_len=64, dtype="float32")
STEPS, STAGES, BATCH, SEQ = 16, 4, 8, 64
LOSS_RTOL, RECOVERY_RTOL = 1e-4, 1e-3
RANK_TIMEOUT_S = 600.0
CORRUPT_RANK, CORRUPT_AFTER = 2, 8

# name -> (strategy, schedule class, events, RecoveryConfig fields, window)
RUNS = {
    "checkpoint": ("checkpoint", "Forced", {2: [1], 7: [2], 13: [1, 2]},
                   dict(checkpoint_every=4), 1),
    # rank 2's save at step 8 unreadable at the wall-13 rollback: 4, not 8
    "checkpoint-corrupt": ("checkpoint", "Forced", {7: [2], 13: [1]},
                           dict(checkpoint_every=4), 1),
    "adaptive-calm": ("adaptive", "Calm", {3: [2], 7: [1], 13: [2]},
                      dict(checkpoint_every=2, adaptive_window=4), 1),
    "adaptive-stormy": ("adaptive", "Stormy", {5: [2], 10: [1]},
                        dict(checkpoint_every=2, adaptive_window=4), 1),
    "adaptive-stormy-w4": ("adaptive", "Stormy", {5: [2], 10: [1]},
                           dict(checkpoint_every=2, adaptive_window=4), 4),
    "tiered_ckpt": ("tiered_ckpt", "Forced", {0: [1], 5: [2], 9: [1, 2]},
                    dict(checkpoint_every=4), 1),
    "neighbor": ("neighbor", "Forced", {0: [3], 5: [1, 2]},
                 dict(checkpoint_every=2), 1),
    "neighbor_no_cold": ("neighbor", "Forced", {5: [1, 2]},
                         dict(neighbor_cold=False), 1),
}
# tests/test_torch_trainer_store.py's restore logs
RESTORE_LOGS = {
    "tiered_ckpt": [(0, 1, -1, "init"), (5, 2, 5, "mem"), (9, 1, 8, "disk"),
                    (9, 2, 9, "mem")],
    "neighbor": [(0, 3, -1, "init"), (5, 1, 4, "disk"), (5, 2, 5, "mem")],
    "neighbor_no_cold": [(5, 1, -1, "init"), (5, 2, 5, "mem")],
}


class Forced:
    """tests/test_torch_trainer.py's schedule of fixed events, with the
    pricing hooks a simulated cluster exposes."""

    def __init__(self, events):
        self.events = events
        self.rates = []

    def at(self, step):
        return list(self.events.get(step, []))

    def iteration_factor(self, step):
        return 1.0 + 0.25 * (step % 3)

    def failure_overhead(self, step, stage, nbytes=None):
        return 7.0 + stage

    def observed_rate(self, step):
        self.rates.append(step)
        return 0.0


class Calm(Forced):
    observed_rate = None


class Stormy(Forced):
    def observed_rate(self, step):
        self.rates.append(step)
        return 0.5 if 4 <= step < 8 else 0.0


SCHEDULES = {"Forced": Forced, "Calm": Calm, "Stormy": Stormy}


def mini_config():
    return get_config("paper-llama-124m").replace(**MINI)


def trainer_config(strategy, window, directory, **rcfg):
    """tests/test_torch_trainer.py's ``configs`` at ``window``, the
    checkpoints and stores under ``directory``."""
    return TrainConfig(
        global_batch=BATCH, microbatch=BATCH, seq_len=SEQ, steps=STEPS,
        eval_every=8, fuse_window=window,
        optimizer=OptimizerConfig(lr=6e-4, total_steps=STEPS),
        recovery=RecoveryConfig(
            strategy=strategy, num_stages=STAGES,
            protect_edge_stages=strategy != "checkfree_plus",
            checkpoint_dir=os.path.join(directory, "ckpt"),
            store_dir=os.path.join(directory, "store"), **rcfg))


def corrupt_after(trainer, step, pkg="repro_torch"):
    """Make the newest checkpoint unreadable once, after the save at
    ``step``: the checkpointer's disk tiers of package ``pkg`` (the port, or
    ``repro`` for the JAX trainer) become that package's fault-injecting
    ones (``statestore.faults``), and the first read after that save raises
    its ``CodecError``, as a corrupted file does.  Returns the undo."""
    ckpt_mod = importlib.import_module(pkg + ".ckpt.checkpoint")
    CodecError = importlib.import_module(pkg + ".statestore.codec").CodecError
    faults = importlib.import_module(pkg + ".statestore.faults")
    spec = ckpt_mod._SHIM_SPEC if pkg == "repro" else ckpt_mod._SPEC
    tier_fn, tiers = ckpt_mod._tier, []

    def faulty(directory):
        tier = faults.FaultInjectingDiskTier(spec, directory,
                                             template=ckpt_mod._CKPT_TEMPLATE)
        tiers.append(tier)
        return tier

    strategy = trainer.strategy
    after_step = strategy.after_step

    def armed(state, hist):
        after_step(state, hist)
        if state.effective_step == step:
            tiers[0].inject("get", times=1, exc=CodecError(
                f"injected corruption of the save at step {step}"))

    ckpt_mod._tier = faulty
    strategy.after_step = armed

    def undo():
        ckpt_mod._tier = tier_fn
    return undo


def run_port(rank, name, directory, params, backend):
    """One run of ``RUNS`` on the port -> (History, strategy)."""
    strategy, kind, events, rcfg, window = RUNS[name]
    cfg = mini_config()
    trainer = Trainer(Model(cfg, device="cpu", weights=False),
                      trainer_config(strategy, window, directory, **rcfg),
                      wall=WallClockModel(model_bytes=8 * cfg.param_count()),
                      schedule=SCHEDULES[kind](events), backend=backend)
    undo = None
    if name == "checkpoint-corrupt" and rank in (None, CORRUPT_RANK):
        undo = corrupt_after(trainer, CORRUPT_AFTER)
    try:
        src = SyntheticLM(512, seed=1234)
        evals = [next(make_batches(cfg, batch=BATCH, seq=SEQ, seed=s,
                                   source=src)) for s in (7, 8)]
        state, hist = trainer.run(make_batches(cfg, batch=BATCH, seq=SEQ,
                                               seed=0, source=src),
                                  evals, params=TR.clone(params))
    finally:
        if undo is not None:
            undo()
    assert state.effective_step == STEPS
    return hist, trainer.strategy


def run_jax_corrupt(directory):
    """The JAX trainer's run of ``checkpoint-corrupt`` at ``fuse_window=1``
    (tests/test_torch_trainer.py's ``run_pair``, JAX's half), its one
    checkpoint at step CORRUPT_AFTER made unreadable alike -> History."""
    from repro.config import (OptimizerConfig as JOpt,
                              RecoveryConfig as JRec, TrainConfig as JTrain)
    from repro.configs import get_config as jax_get_config
    from repro.core.trainer import Trainer as JTrainer
    from repro.core.walltime import WallClockModel as JWall
    from repro.data.pipeline import SyntheticLM as JSource
    from repro.data.pipeline import make_batches as jax_make_batches
    from repro.models.model import build_model as jax_build_model
    import test_torch_trainer_ckpt as TC
    from test_torch_trainer import configs

    strategy, _, events, rcfg, _ = RUNS["checkpoint-corrupt"]
    jcfg = jax_get_config("paper-llama-124m").replace(**MINI)
    jmodel = jax_build_model(jcfg)
    src = JSource(512, seed=1234)
    evals = [next(jax_make_batches(jcfg, batch=BATCH, seq=SEQ, seed=s,
                                   source=src)) for s in (7, 8)]
    trainer = JTrainer(jmodel, configs(
        strategy, JOpt, JRec, JTrain,
        checkpoint_dir=os.path.join(directory, "ckpt"),
        store_dir=os.path.join(directory, "store"), **rcfg),
        wall=JWall(model_bytes=8 * jcfg.param_count()),
        schedule=TC.Forced(events))
    undo = corrupt_after(trainer, CORRUPT_AFTER, pkg="repro")
    try:
        state, hist = trainer.run(jax_make_batches(
            jcfg, batch=BATCH, seq=SEQ, seed=0, source=src), evals)
    finally:
        undo()
    assert int(state.effective_step) == STEPS
    return hist


def _runs_rank(rank, inp):
    params = params_from_numpy(inp["params"], device="cpu")
    out = {}
    for name in RUNS:
        hist, strategy = run_port(rank, name,
                                  os.path.join(inp["dir"], name), params,
                                  "spmd")
        out[name] = {"hist": hist,
                     "restore_log": getattr(strategy, "restore_log", None),
                     "switches": getattr(strategy, "switches", None),
                     "group_reduce": strategy.group_reduce is not None}
    out["jax_imported"] = any(m.split(".")[0] in ("jax", "jaxlib", "repro")
                              for m in sys.modules)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spmd runs on four ranks, the JAX and port host runs of each
    schedule at window 1 (``run_pair``), and the host run with its one
    checkpoint corrupted as rank 2's."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models.model import build_model as jax_build_model
    import test_torch_trainer_ckpt as TC
    from test_torch_trainer import run_pair

    jmodel = jax_build_model(jax_get_config("paper-llama-124m")
                             .replace(**MINI))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    spmd_runs = spawn_stages(
        _runs_rank, STAGES,
        {"params": params, "dir": str(tmp_path_factory.mktemp("spmd"))},
        timeout_s=RANK_TIMEOUT_S,
        workdir=str(tmp_path_factory.mktemp("ranks")))
    pairs = {}
    jax_schedules = {"Forced": TC.Forced, "Calm": TC.Calm,
                     "Stormy": TC.Stormy}
    for name, (strategy, kind, events, rcfg, window) in RUNS.items():
        if name == "checkpoint-corrupt" or window > 1:
            continue
        jtrainer, jhist, trainer, hist = run_pair(
            strategy, jax_schedules[kind](events), SCHEDULES[kind](events),
            tmp_path_factory.mktemp(name), **rcfg)
        pairs[name] = (jtrainer, jhist, trainer, hist)
    corrupt = run_port(None, "checkpoint-corrupt",
                       str(tmp_path_factory.mktemp("host-corrupt")),
                       params_from_numpy(params, device="cpu"), "host")
    jax_corrupt = run_jax_corrupt(str(tmp_path_factory.mktemp("jax-corrupt")))
    return {"spmd": spmd_runs, "pairs": pairs, "corrupt": corrupt,
            "jax_corrupt": jax_corrupt}


def test_ranks_import_no_jax_and_bind_the_group(runs):
    assert not any(r["jax_imported"] for r in runs["spmd"])
    assert all(r[name]["group_reduce"] for r in runs["spmd"] for name in RUNS)


def same_trace(hist, want, *, dispatches=True):
    """tests/test_torch_trainer.py's ``check_same_trace``."""
    assert [tuple(f) for f in hist.failures] == \
        [tuple(f) for f in want.failures]
    assert hist.steps == want.steps and hist.wall_iters == want.wall_iters
    if dispatches:
        assert hist.dispatches == hist.wall_iters
    np.testing.assert_allclose(hist.loss, want.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist.wall_time, want.wall_time, rtol=1e-12)
    assert [s for s, _ in hist.recovery_errors] == \
        [s for s, _ in want.recovery_errors]
    np.testing.assert_allclose([e for _, e in hist.recovery_errors],
                               [e for _, e in want.recovery_errors],
                               rtol=RECOVERY_RTOL)
    assert [s for s, _, _ in hist.eval_loss] == \
        [s for s, _, _ in want.eval_loss]
    np.testing.assert_allclose([e for _, _, e in hist.eval_loss],
                               [e for _, _, e in want.eval_loss],
                               rtol=LOSS_RTOL)
    assert not hist.truncated


def rank_runs(runs, name):
    """Rank 0's run of ``name``, after checking that every rank holds the
    same History (NaN recovery errors equal: compared as JSON), restore log
    and switches."""
    ranks = [r[name] for r in runs["spmd"]]
    first = ranks[0]
    for r in ranks[1:]:
        assert r["hist"].to_json() == first["hist"].to_json()
        assert r["restore_log"] == first["restore_log"]
        assert r["switches"] == first["switches"]
    return first


@pytest.mark.parametrize("name", sorted(n for n in RUNS
                                        if n != "checkpoint-corrupt"))
def test_spmd_runs_match_jax_and_the_host_backend(runs, name):
    strategy, _, _, _, window = RUNS[name]
    got = rank_runs(runs, name)
    hist = got["hist"]
    pair = name if window == 1 else name.rsplit("-", 1)[0]
    jtrainer, jhist, trainer, host = runs["pairs"][pair]
    same_trace(hist, jhist)
    same_trace(hist, host)
    assert hist.failures
    if strategy in ("tiered_ckpt", "neighbor"):
        assert got["restore_log"] == jtrainer.strategy.restore_log == \
            trainer.strategy.restore_log == RESTORE_LOGS[name]
        hot = [i for i, row in enumerate(got["restore_log"])
               if row[3] == "mem"]
        assert hot and all(hist.recovery_errors[i][1] == 0.0 for i in hot)
    if strategy == "adaptive":
        assert got["switches"] == jtrainer.strategy.switches == \
            trainer.strategy.switches
        assert [(a, b) for _, a, b in got["switches"]][:2] == [
            ("checkfree", "checkpoint"), ("checkpoint", "checkfree")]
        assert any(math.isnan(e) for _, e in hist.recovery_errors)
        assert any(not math.isnan(e) for _, e in hist.recovery_errors)
    if strategy == "checkpoint":
        assert hist.steps[:4] == [1, 2, 1, 2]           # the restart
        assert hist.steps[6:9] == [5, 5, 6]             # rollback 5 -> 4
        assert all(math.isnan(e) for _, e in hist.recovery_errors)


def test_a_corrupted_save_on_one_rank_sends_every_rank_back_alike(runs):
    """Rank 2 alone cannot read its save at step 8 at the wall-13 rollback:
    every rank restores step 4, as the JAX trainer and the port's host
    trainer do with their one checkpoint at step 8 corrupted."""
    hist = rank_runs(runs, "checkpoint-corrupt")["hist"]
    host, _ = runs["corrupt"]
    same_trace(hist, runs["jax_corrupt"])
    same_trace(hist, host)
    same_trace(host, runs["jax_corrupt"])
    # wall 7 rolls back from step 7 to 4; wall 13 from 10 to 4, not 8
    assert hist.steps[6:8] == [7, 5]
    assert hist.steps[12:14] == [10, 5]
    assert hist.wall_iters == STEPS + 3 + 6
