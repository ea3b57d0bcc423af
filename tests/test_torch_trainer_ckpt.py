"""The port's eager Trainer against the JAX Trainer (fuse_window=1) for the
strategies that roll back: ``checkpoint`` and ``adaptive``.

The 16-step runs of tests/test_torch_trainer.py (its model, data, JAX
initial parameters and tolerances, stated there) under forced schedules
that restart before the first save, roll back, and switch ``adaptive``
from ``checkfree`` to ``checkpoint`` under fire and back.  The
effective-step trace through each rollback, the failures and the wall
iterations must be equal; a rollback's recovery error is NaN in both.
"""
import math

import pytest

from test_torch_trainer import (STEPS, Forced, check_same_trace,  # noqa: F401
                                one_torch_thread, run_pair)


class Calm(Forced):
    """Forced events with the pricing hooks but no observed failure rate,
    so that ``adaptive`` switches on its own sliding window."""

    observed_rate = None


class Stormy(Forced):
    """Forced events and an observed failure rate of 0.5 on wall steps
    4-7, which drives ``adaptive`` to its high child and back."""

    def observed_rate(self, step):
        self.rates.append(step)
        return 0.5 if 4 <= step < 8 else 0.0


def test_checkpoint_matches_jax_through_restart_and_rollbacks(tmp_path):
    """Wall 2 fails before the first save (restart from the initial
    parameters at step 0); wall 7 rolls back from step 5 to the save at 4;
    wall 13 loses two stages, each rolled back to the save at 8."""
    events = {2: [1], 7: [2], 13: [1, 2]}
    _, jhist, trainer, hist = run_pair("checkpoint", Forced(events),
                                       Forced(events), tmp_path,
                                       checkpoint_every=4)
    check_same_trace(jhist, hist)
    assert hist.steps[:4] == [1, 2, 1, 2]          # the restart
    assert hist.steps[6:9] == [5, 5, 6]            # rollback 5 -> 4
    assert hist.wall_iters > STEPS
    assert all(math.isnan(e) for _, e in hist.recovery_errors)
    assert len(hist.recovery_errors) == 4


@pytest.mark.parametrize("schedule", [Calm, Stormy])
def test_adaptive_matches_jax_switching_under_fire(schedule, tmp_path):
    """``checkfree`` while calm, ``checkpoint`` (shadow-saving every 2
    steps all along) once the failure rate crosses the threshold, and back.
    Calm: the sliding window of 4 iterations trips on the merge at wall 3;
    the failure at wall 7 rolls back from step 7 to the save at 6.  Stormy:
    the schedule's observed rate trips it at wall 4, and the failure at
    wall 5 rolls back from step 5 to 4."""
    events = ({3: [2], 7: [1], 13: [2]} if schedule is Calm
              else {5: [2], 10: [1]})
    jtrainer, jhist, trainer, hist = run_pair(
        "adaptive", schedule(events), schedule(events), tmp_path,
        checkpoint_every=2, adaptive_window=4)
    check_same_trace(jhist, hist)
    assert trainer.strategy.switches == jtrainer.strategy.switches
    assert [(a, b) for _, a, b in trainer.strategy.switches][:2] == [
        ("checkfree", "checkpoint"), ("checkpoint", "checkfree")]
    assert hist.wall_iters == STEPS + 1                  # one step replayed
    assert any(math.isnan(e) for _, e in hist.recovery_errors)   # rollback
    assert any(not math.isnan(e) for _, e in hist.recovery_errors)  # merge
