"""The port's ``Trainer(backend="spmd")`` on 4 gloo ranks of the CPU against
the JAX host trainer and the port's host trainer, and rank 0's telemetry
(items (e) and (g) of tests/test_torch_pipeline_spmd.py, which says more).

One spawn runs every spmd run; the JAX and host runs are in this process.
The ranks import this module and tests/test_torch_pipeline_spmd.py, neither
of which imports JAX at import time.
"""
import sys

import numpy as np
import pytest

from repro_torch import configs as CS
from repro_torch import telemetry
from repro_torch import tree as TR
from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import make_batches
from repro_torch.launch.mesh import spawn_stages
from repro_torch.models.model import Model

from test_torch_pipeline_spmd import (BATCH, K, LOSS_RTOL,  # noqa: F401
                                      RANK_TIMEOUT_S, RECOVERY_RTOL, RUNS,
                                      SEQ, STEPS, WINDOWS, Forced,
                                      _tensors, one_torch_thread,
                                      train_config, trainer_config)


def _runs_rank(rank, inp):
    """(e) and (g): the Trainer runs, rank 0 recording the window-1 runs."""
    from repro_torch.core.walltime import WallClockModel
    cfg = train_config(CS)
    params = _tensors(inp["params"])
    out = {}
    for name, events in RUNS.items():
        for window in WINDOWS:
            tcfg = trainer_config(OptimizerConfig, RecoveryConfig,
                                  TrainConfig, name, window)
            trainer = Trainer(Model(cfg, device="cpu", weights=False), tcfg,
                              wall=WallClockModel(
                                  model_bytes=8 * cfg.param_count()),
                              schedule=Forced(events), backend="spmd")
            assert trainer.strategy._in_mesh_recover is not None
            record = rank == 0 and window == 1
            rec = telemetry.Recorder(None) if record else None
            prev = telemetry.set_recorder(rec) if record else None
            try:
                evals = [next(make_batches(cfg, batch=BATCH, seq=SEQ,
                                           seed=7))]
                state, hist = trainer.run(
                    make_batches(cfg, batch=BATCH, seq=SEQ, seed=0), evals,
                    params=TR.clone(params))
            finally:
                if record:
                    telemetry.set_recorder(prev)
                    rec.close()
            out[name, window] = {
                "hist": hist, "effective_step": state.effective_step,
                "events": list(rec.events) if record else None,
                "spans": list(rec.spans) if record else None}
    out["jax_imported"] = any(m.split(".")[0] in ("jax", "jaxlib", "repro")
                              for m in sys.modules)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(e), (g): the spmd runs on the ranks, the port's host runs and the
    JAX host runs at window 1 (recorded), from JAX's parameters."""
    import jax
    from repro import configs as JCS
    from repro import telemetry as jtel
    from repro.config import OptimizerConfig as JOpt
    from repro.config import RecoveryConfig as JRec
    from repro.config import TrainConfig as JTrain
    from repro.core.trainer import Trainer as JTrainer
    from repro.core.walltime import WallClockModel as JWall
    from repro.data.pipeline import make_batches as jax_make_batches
    from repro.models.model import build_model
    from repro_torch.core.walltime import WallClockModel

    jcfg, cfg = train_config(JCS), train_config(CS)
    jmodel = build_model(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    spmd_runs = spawn_stages(_runs_rank, K, {"params": params},
                             timeout_s=RANK_TIMEOUT_S,
                             workdir=str(tmp_path_factory.mktemp("runs")))
    out = {"spmd": spmd_runs, "jax": {}, "host": {}}
    for name, events in RUNS.items():
        rec = jtel.Recorder(None)
        prev = jtel.set_recorder(rec)
        try:
            jtrainer = JTrainer(jmodel, trainer_config(JOpt, JRec, JTrain,
                                                       name, 1),
                                wall=JWall(model_bytes=8 *
                                           jcfg.param_count()),
                                schedule=Forced(events))
            _, jhist = jtrainer.run(
                jax_make_batches(jcfg, batch=BATCH, seq=SEQ, seed=0),
                [next(jax_make_batches(jcfg, batch=BATCH, seq=SEQ,
                                       seed=7))])
        finally:
            jtel.set_recorder(prev)
            rec.close()
        out["jax"][name] = (jhist, list(rec.events), list(rec.spans))
        trainer = Trainer(Model(cfg, device="cpu", weights=False),
                          trainer_config(OptimizerConfig, RecoveryConfig,
                                         TrainConfig, name, 1),
                          wall=WallClockModel(model_bytes=8 *
                                              cfg.param_count()),
                          schedule=Forced(events))
        _, hist = trainer.run(
            make_batches(cfg, batch=BATCH, seq=SEQ, seed=0),
            [next(make_batches(cfg, batch=BATCH, seq=SEQ, seed=7))],
            params=_tensors(params))
        out["host"][name] = hist
    return out



def test_ranks_import_no_jax(runs):
    assert not any(r["jax_imported"] for r in runs["spmd"])


# ---------------------------------------------------------------------------

def same_run(hist, want):
    assert [tuple(f) for f in hist.failures] == \
        [tuple(f) for f in want.failures]
    assert hist.steps == want.steps and hist.wall_iters == want.wall_iters
    np.testing.assert_allclose(hist.loss, want.loss, rtol=LOSS_RTOL)
    assert [s for s, _ in hist.recovery_errors] == \
        [s for s, _ in want.recovery_errors]
    np.testing.assert_allclose([e for _, e in hist.recovery_errors],
                               [e for _, e in want.recovery_errors],
                               rtol=RECOVERY_RTOL)
    np.testing.assert_allclose([e for _, _, e in hist.eval_loss],
                               [e for _, _, e in want.eval_loss],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist.wall_time, want.wall_time, rtol=1e-12)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", sorted(RUNS))
def test_trainer_runs_match_jax_and_the_host_backend(runs, name, window):
    ranks = [r[name, window] for r in runs["spmd"]]
    hist = ranks[0]["hist"]
    assert ranks[0]["effective_step"] == STEPS and hist.failures
    for r in ranks[1:]:               # every rank holds the same history
        assert r["hist"] == hist
    if window > 1:
        assert hist.dispatches < hist.wall_iters
    same_run(hist, runs["jax"][name][0])
    same_run(hist, runs["host"][name])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_rank0_telemetry_matches_the_jax_host_run(runs, name):
    from test_torch_telemetry import same_records
    _, jev, jsp = runs["jax"][name]
    run = runs["spmd"][0][name, 1]
    ev, sp = run["events"], run["spans"]
    assert telemetry.validate_events(ev) == []
    assert [e["kind"] for e in ev] == [e["kind"] for e in jev]
    same_records(jev, ev, skip={"t_s", "duration_s", "backend"})
    assert [e["backend"] for e in ev if "backend" in e] == ["spmd"]
    pipeline = [s for s in sp if s["name"] == "spmd_window_dispatch"]
    assert len(pipeline) == run["hist"].dispatches == sum(
        s["name"] == "window_dispatch" for s in sp)
    assert all(s["cat"] == "pipeline" and s["args"] == {"stages": K}
               for s in pipeline)
    spans = [dict(name=s["name"], cat=s["cat"], **s["args"]) for s in sp
             if s["name"] != "spmd_window_dispatch"]
    jspans = [dict(name=s["name"], cat=s["cat"], **s["args"]) for s in jsp]
    same_records(jspans, spans, skip={"backend"})
