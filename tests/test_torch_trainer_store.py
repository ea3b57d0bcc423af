"""The port's eager Trainer against the JAX Trainer (fuse_window=1) for the
state-store strategies ``tiered_ckpt`` and ``neighbor``.

The 16-step runs of tests/test_torch_trainer.py (its model, data, JAX
initial parameters and tolerances, stated there) under forced schedules: a
failure before the first snapshot (the stage re-initialised), a hot-tier
restore, and the double failure of a shard and its replica holder, served
from the disk safety net or, without one, by re-initialising the stage.
Which tier served each restore (``restore_log``) must be equal.
"""
import pytest

from test_torch_trainer import (Forced, check_same_trace,  # noqa: F401
                                one_torch_thread, run_pair)

CASES = {
    # wall 0 before any snapshot; wall 5 hot; wall 9 a consecutive pair
    # whose first shard lived on the second's host: disk at step 8
    "tiered_ckpt": ("tiered_ckpt", {0: [1], 5: [2], 9: [1, 2]},
                    dict(checkpoint_every=4),
                    [(0, 1, -1, "init"), (5, 2, 5, "mem"), (9, 1, 8, "disk"),
                     (9, 2, 9, "mem")]),
    "neighbor": ("neighbor", {0: [3], 5: [1, 2]}, dict(checkpoint_every=2),
                 [(0, 3, -1, "init"), (5, 1, 4, "disk"), (5, 2, 5, "mem")]),
    "neighbor_no_cold": ("neighbor", {5: [1, 2]}, dict(neighbor_cold=False),
                         [(5, 1, -1, "init"), (5, 2, 5, "mem")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_store_strategies_match_jax(case, tmp_path):
    strategy, events, rcfg, log = CASES[case]
    jtrainer, jhist, trainer, hist = run_pair(strategy, Forced(events),
                                              Forced(events), tmp_path,
                                              **rcfg)
    check_same_trace(jhist, hist)
    assert trainer.strategy.restore_log == jtrainer.strategy.restore_log
    assert trainer.strategy.restore_log == log
    # a hot restore of the current step loses nothing
    hot = [i for i, row in enumerate(log) if row[3] == "mem"]
    assert all(hist.recovery_errors[i][1] == 0.0 for i in hot)
