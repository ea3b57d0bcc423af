"""The port's eager Trainer against the JAX Trainer under the seeded failure
schedule, and the port's training driver.

The same 16-step runs as tests/test_torch_trainer.py (and its tolerances,
stated there), under ``FailureSchedule(seed=42)`` as in
examples/train_with_failures.py:44-47, each package with its own copy of the
schedule.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.core.failures import FailureSchedule as JFailureSchedule
from repro_torch.core.failures import FailureSchedule
from repro_torch.core.state import History
from repro_torch.core.trainer import Trainer
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models.model import Model

from test_torch_trainer import (check_same_run, one_torch_thread,  # noqa: F401
                                run_both, seeded)


@pytest.mark.parametrize("strategy", ["checkfree", "checkfree_plus"])
def test_trainer_matches_jax_under_the_seeded_schedule(strategy):
    jhist, hist = run_both(strategy, seeded(strategy, JFailureSchedule),
                           seeded(strategy, FailureSchedule))
    check_same_run(jhist, hist)


def test_train_cli_on_cpu(tmp_path):
    out = tmp_path / "history.json"
    hist = train.main(["--reduced", "--device", "cpu", "--strategy",
                       "checkfree_plus", "--steps", "4", "--seq", "32",
                       "--batch", "4", "--quiet", "--out", str(out)])
    assert len(hist.loss) == 4 and all(np.isfinite(hist.loss))
    assert History.from_json(out.read_text()) == hist


@pytest.mark.parametrize("flags", [["--backend", "spmd", "--arch",
                                    "mamba2-1.3b"],
                                   ["--trace"],
                                   ["--depart-prob", "0.1"],
                                   ["--backend", "spmd", "--arch",
                                    "h2o-danube-3-4b", "--telemetry-dir",
                                    "x"]])
def test_train_cli_refuses_unported_flags_by_name(flags, capsys, tmp_path,
                                                  monkeypatch):
    """``--backend spmd`` refuses the ssm family and a sliding window, by
    name; ``--trace`` needs ``--telemetry-dir``; ``--depart-prob`` needs
    ``--scenario``.  A refused run makes no run directory."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        train.main(["--reduced", "--device", "cpu", *flags])
    assert flags[0] in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_train_cli_runs_spmd_on_cpu(tmp_path):
    """``--backend spmd`` on two gloo ranks of the CPU: finite losses, and
    rank 0's History in ``--out``."""
    out = tmp_path / "history.json"
    hist = train.main(["--backend", "spmd", "--reduced", "--layers", "4",
                       "--stages", "2", "--device", "cpu", "--strategy",
                       "checkfree_plus", "--steps", "4", "--seq", "32",
                       "--batch", "4", "--quiet", "--out", str(out)])
    assert hist.steps == [1, 2, 3, 4] and all(np.isfinite(hist.loss))
    assert History.from_json(out.read_text()) == hist


def test_train_cli_runs_spmd_with_a_snapshot_strategy_on_cpu(tmp_path,
                                                             monkeypatch):
    """``--backend spmd --strategy checkpoint`` on three gloo ranks of the
    CPU: two failures before the first save restart every rank from the
    initial parameters, as on the host backend; the ranks' checkpoints lie
    in one run directory under the temporary directory (here tmp_path),
    gone when the run ends."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    flags = ["--reduced", "--layers", "6", "--stages", "3", "--device",
             "cpu", "--strategy", "checkpoint", "--steps", "6", "--seq",
             "32", "--batch", "4", "--rate", "10", "--quiet"]
    hist = train.main(["--backend", "spmd", *flags])
    host = train.main(flags)
    assert [tuple(f) for f in hist.failures] == \
        [tuple(f) for f in host.failures] and len(hist.failures) == 2
    assert hist.steps == host.steps and hist.wall_iters > 6
    assert all(np.isnan(e) for _, e in hist.recovery_errors)
    # each restart trains step 1 again from the initial parameters: the
    # same loss to the bit (the bf16 losses of the two backends drift apart
    # later, by 2e-4 here; tests/test_torch_pipeline_spmd_store.py holds
    # the backends to JAX in fp32)
    assert [x for s, x in zip(hist.steps, hist.loss) if s == 1] == \
        [hist.loss[0]] * hist.steps.count(1) and hist.steps.count(1) == 3
    assert all(np.isfinite(hist.loss))
    assert not os.listdir(tmp_path)


def test_training_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    cfg = get_config("paper-llama-124m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Model(cfg, weights=False), TrainConfig())


@pytest.mark.parametrize("strategy", ["checkpoint", "tiered_ckpt", "neighbor",
                                      "adaptive"])
def test_train_cli_runs_the_checkpointing_strategies(strategy, tmp_path,
                                                     monkeypatch):
    """``--strategy`` reaches every ported baseline through the registry.
    Their directories lie in a directory of the run's own under the
    temporary directory (here tmp_path), which is gone when the run ends."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = []

    class Recording(Trainer):
        def __init__(self, model, tcfg, **kw):
            seen.append((tcfg.recovery.checkpoint_dir,
                         tcfg.recovery.store_dir))
            super().__init__(model, tcfg, **kw)

    monkeypatch.setattr(train, "Trainer", Recording)
    hist = train.main(["--reduced", "--device", "cpu", "--strategy", strategy,
                       "--steps", "3", "--seq", "32", "--batch", "2",
                       "--rate", "0", "--quiet"])
    assert hist.steps == [1, 2, 3] and all(np.isfinite(hist.loss))
    [(ckpt_dir, store_dir)] = seen
    run_dir = os.path.dirname(ckpt_dir)
    assert os.path.dirname(run_dir) == str(tmp_path)
    assert os.path.dirname(store_dir) == run_dir
    assert not os.listdir(tmp_path)
