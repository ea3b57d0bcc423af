"""The port's eager Trainer against the JAX Trainer (fuse_window=1), end to end.

The reduced paper-LLaMA of examples/train_with_failures.py (8 layers,
d_model 128, fp32, 4 stages, batch 8 x 64) trains 16 steps in both packages
from JAX's initial parameters (``convert.params_from_numpy``) on the same
numpy batches, for ``checkfree`` and ``checkfree_plus``, under a forced
schedule (this file) and under ``FailureSchedule(seed=42)``
(tests/test_torch_trainer_seeded.py).  Failure steps and stages must match
exactly.  Losses are held at 1e-4 relative: both compute in fp32 but sum the
matrix products in other orders, and Adam's normalised updates carry those
differences through 16 steps and four recoveries.  Recovery errors are held
at 1e-3 relative: each is a squared distance between stages whose entries
differ by the same rounding, and a merge from nearly equal neighbours
subtracts nearly equal numbers.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import (OptimizerConfig as JOpt, RecoveryConfig as JRec,
                          TrainConfig as JTrain)
from repro.configs import get_config as jax_get_config
from repro.core.trainer import Trainer as JTrainer
from repro.core.walltime import WallClockModel as JWall
from repro.data.pipeline import SyntheticLM as JSource
from repro.data.pipeline import make_batches as jax_make_batches
from repro.models.model import build_model as jax_build_model
from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.trainer import Trainer
from repro_torch.core.walltime import WallClockModel
from repro_torch.data.pipeline import SyntheticLM, make_batches
from repro_torch.models.model import Model

MINI = dict(name="paper-llama-124m-mini", num_layers=8, d_model=128,
            num_heads=4, num_kv_heads=4, d_ff=344, vocab_size=512,
            max_seq_len=64, dtype="float32")
STEPS, STAGES, BATCH, SEQ = 16, 4, 8, 64
LOSS_RTOL, RECOVERY_RTOL = 1e-4, 1e-3
FORCED = {4: [2], 9: [0], 12: [1, 2]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Forced:
    """A schedule of fixed events (any object with ``.at(step)``), with the
    optional pricing hooks a simulated cluster exposes."""

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


def configs(strategy, O, R, T, **rcfg):
    return T(global_batch=BATCH, microbatch=BATCH, seq_len=SEQ, steps=STEPS,
             eval_every=8, fuse_window=1,
             optimizer=O(lr=6e-4, total_steps=STEPS),
             recovery=R(strategy=strategy, num_stages=STAGES,
                        protect_edge_stages=strategy != "checkfree_plus",
                        **rcfg))


def seeded(strategy, cls):
    """The schedule of examples/train_with_failures.py:44-47."""
    return cls(rate_per_hour=0.10, iteration_time_s=600.0,
               num_stages=STAGES, steps=STEPS * 10, seed=42,
               protect_edges=strategy != "checkfree_plus")


def run_both(strategy, jax_schedule, schedule):
    """(JAX history, port history) of the same 16-step run."""
    _, jhist, _, hist = run_pair(strategy, jax_schedule, schedule)
    return jhist, hist


def run_pair(strategy, jax_schedule, schedule, tmp=None, **rcfg):
    """(JAX trainer, JAX history, port trainer, port history) of the same
    16-step run; ``rcfg`` goes to both packages' ``RecoveryConfig``, and
    each package keeps its checkpoints and state store under ``tmp``."""
    dirs = {}
    for pkg in ("jax", "torch"):
        dirs[pkg] = ({} if tmp is None else
                     dict(checkpoint_dir=str(tmp / f"{pkg}_ckpt"),
                          store_dir=str(tmp / f"{pkg}_store")))
    jcfg = jax_get_config("paper-llama-124m").replace(**MINI)
    cfg = get_config("paper-llama-124m").replace(**MINI)
    jmodel = jax_build_model(jcfg)
    jsrc, src = JSource(512, seed=1234), SyntheticLM(512, seed=1234)
    jevals = [next(jax_make_batches(jcfg, batch=BATCH, seq=SEQ, seed=s,
                                    source=jsrc)) for s in (7, 8)]
    evals = [next(make_batches(cfg, batch=BATCH, seq=SEQ, seed=s, source=src))
             for s in (7, 8)]
    jtrainer = JTrainer(jmodel, configs(strategy, JOpt, JRec, JTrain,
                                        **dirs["jax"], **rcfg),
                        wall=JWall(model_bytes=8 * jcfg.param_count()),
                        schedule=jax_schedule)
    _, jhist = jtrainer.run(jax_make_batches(jcfg, batch=BATCH, seq=SEQ,
                                             seed=0, source=jsrc), jevals)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        device="cpu")
    trainer = Trainer(Model(cfg, device="cpu", weights=False),
                      configs(strategy, OptimizerConfig, RecoveryConfig,
                              TrainConfig, **dirs["torch"], **rcfg),
                      wall=WallClockModel(model_bytes=8 * cfg.param_count()),
                      schedule=schedule)
    state, hist = trainer.run(make_batches(cfg, batch=BATCH, seq=SEQ, seed=0,
                                           source=src), evals, params=params)
    assert state.effective_step == STEPS
    return jtrainer, jhist, trainer, hist


def check_same_run(jhist, hist):
    check_same_trace(jhist, hist)
    assert hist.dispatches == hist.wall_iters == STEPS


def check_same_trace(jhist, hist):
    """The same failures, effective-step trace (through any rollback) and
    wall iterations; losses, modelled wall time, recovery errors (NaN for a
    rollback, equal to NaN) and eval losses within the tolerances."""
    assert [tuple(f) for f in hist.failures] == \
        [tuple(f) for f in jhist.failures]
    assert hist.steps == jhist.steps and hist.wall_iters == jhist.wall_iters
    assert hist.dispatches == hist.wall_iters
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist.wall_time, jhist.wall_time, rtol=1e-12)
    assert [s for s, _ in hist.recovery_errors] == \
        [s for s, _ in jhist.recovery_errors]
    np.testing.assert_allclose([e for _, e in hist.recovery_errors],
                               [e for _, e in jhist.recovery_errors],
                               rtol=RECOVERY_RTOL)
    assert [s for s, _, _ in hist.eval_loss] == \
        [s for s, _, _ in jhist.eval_loss]
    np.testing.assert_allclose([e for _, _, e in hist.eval_loss],
                               [e for _, _, e in jhist.eval_loss],
                               rtol=LOSS_RTOL)
    assert not hist.truncated


@pytest.mark.parametrize("strategy", ["checkfree", "checkfree_plus"])
def test_trainer_matches_jax_under_a_forced_schedule(strategy):
    """A merge at step 4, an edge stage at 9 (checkfree degrades to a copy,
    checkfree_plus copies the twin), a consecutive run at 12; iterations and
    recoveries priced through the schedule's hooks."""
    jax_schedule, schedule = Forced(FORCED), Forced(FORCED)
    jhist, hist = run_both(strategy, jax_schedule, schedule)
    assert [tuple(f) for f in hist.failures] == \
        [(4, 2), (9, 0), (12, 1), (12, 2)]
    check_same_run(jhist, hist)
    assert schedule.rates == jax_schedule.rates == list(range(STEPS))
