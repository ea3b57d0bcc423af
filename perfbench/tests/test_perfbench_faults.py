"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives a whole run of a cell at width 64 on the CPU (the chip's
look skipped: ``bench.run_cell`` on the CPU, the kernels' plain versions),
with one fault planted in the program: a step that returns its state
unchanged (Adam's update left out), half of the batch left out with the
mean taken over the rest, and an answer altered where it is produced (the
largest tower leaf's gradient doubled before the norms and Adam read it);
and, in the fused windows of the SSM mix, every step of a window fed its
first step's batch.
The cells run on one chip, with no exchange between chips to leave out.
The program computes in float32 here, so the sound run reads gaps near
1e-7 against limits of 1e-4."""
import time

import pytest

from perfbench.tests import _tiny
from perfbench.lib import bench

from repro_torch.data.pipeline import WindowPrefetcher
from repro_torch.kernels import ops
from repro_torch.models.model import Model

SEED = 2 ** 31 + 4242


def _run(family):
    cell = _tiny.cell(family)
    return bench.run_cell(cell, SEED, 0.01, False, "cpu",
                          time.perf_counter())


def _unchanged(monkeypatch):
    monkeypatch.setattr(ops, "adam_update", lambda *a, **k: None)


def _half_batch(monkeypatch):
    loss = Model.loss

    def half(self, params, batch, **kw):
        rows = batch["tokens"].shape[0] // 2
        return loss(self, params, {k: v[:rows] for k, v in batch.items()},
                    **kw)

    monkeypatch.setattr(Model, "loss", half)


def _doubled_gradient(monkeypatch):
    sumsq = ops.adam_sumsq

    def doubled(grads, tower, layers):
        big = max((i for i, t in enumerate(tower) if t),
                  key=lambda i: grads[i].numel())
        grads[big].mul_(2.0)
        return sumsq(grads, tower, layers)

    monkeypatch.setattr(ops, "adam_sumsq", doubled)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_a_sound_run_is_correct(family):
    out = _run(family)
    assert out["correct"], out["checks"]
    assert max(c["value"] for c in out["checks"].values()) < 1e-5


@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("fault,catches", [
    (_unchanged, "update_gap"),
    (_half_batch, "loss_gap"),
    (_doubled_gradient, "grad_gap")])
def test_a_broken_step_is_not_correct(family, fault, catches, monkeypatch):
    fault(monkeypatch)
    out = _run(family)
    assert not out["correct"]
    check = out["checks"][catches]
    assert check["value"] > check["limit"], out["checks"]


def _first_batch_replayed(monkeypatch):
    take = WindowPrefetcher.take

    def first(self, step, k):
        stacked = take(self, step, k)
        return {n: v[:1].repeat(len(v), axis=0) for n, v in stacked.items()}

    monkeypatch.setattr(WindowPrefetcher, "take", first)


def test_a_window_that_replays_its_first_batch_is_not_correct(monkeypatch):
    # the SSM mix's check opens with a window of 8 steps
    _first_batch_replayed(monkeypatch)
    out = _run("ssm")
    assert not out["correct"]
    check = out["checks"]["loss_gap"]
    assert check["value"] > check["limit"], out["checks"]


def test_a_number_without_a_limit_is_not_compared():
    from perfbench.lib import check as CK
    values = {"loss_gap": 1.0, "grad_gap": 0.1, "omega_gap": 0.1,
              "update_gap": 0.1}
    ok, table = CK.judge(values, {"grad_gap": 0.2, "omega_gap": 0.2,
                                  "update_gap": 0.2})
    assert ok and sorted(table) == ["grad_gap", "omega_gap", "update_gap"]
    ok, _ = CK.judge(values, {"loss_gap": 0.5, "grad_gap": 0.2})
    assert not ok
    with pytest.raises(ValueError):
        CK.judge(values, {"loss": 0.5})
