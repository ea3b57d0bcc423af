"""The port's runtime guard against JAX's, on the CPU: the sync-free guard,
the pytest markers, and the capture sentinel (tests/test_runtime_guards.py's
cases on ``repro_torch.analysis.runtime``).

The load-bearing assertions:

* the port's trainer completes under ``sync_free()``, its only host reads
  the explicit drains (``repro_torch.tree.device_get``), and its History
  matches the JAX trainer's under JAX's guard: the same failures and
  dispatches, losses within 1e-4 relative (tests/test_torch_trainer.py's
  tolerance: both packages compute in fp32 but sum in other orders);
* the port captures one CUDA graph per stage partition, whatever window
  sizes it dispatched: 0 on the CPU, where nothing is captured, with the
  window sizes JAX dispatched.

The markers and the fixture are enforced in a pytest run of its own,
which loads the plugin with ``-p repro_torch.analysis.pytest_plugin`` on a
test file written to ``tmp_path``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.analysis import runtime as jruntime
from repro.config import ModelConfig as JModelConfig
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import RecoveryConfig as JRecoveryConfig
from repro.config import SSMConfig as JSSMConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core.trainer import Trainer as JTrainer
from repro.data.pipeline import make_batches as jax_make_batches
from repro.models.model import build_model as jax_build_model
from repro_torch import tree as TR
from repro_torch.analysis import runtime
from repro_torch.analysis.runtime import ImplicitHostSyncError
from repro_torch.config import (ModelConfig, OptimizerConfig, RecoveryConfig,
                                SSMConfig, TrainConfig)
from repro_torch.convert import params_from_numpy
from repro_torch.core.stages import StagePartition
from repro_torch.core.trainer import Trainer
from repro_torch.core.window import FusedWindow
from repro_torch.data.pipeline import make_batches
from repro_torch.models.model import Model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# sync_free primitives
# ---------------------------------------------------------------------------

def test_sync_free_blocks_implicit_casts():
    x = torch.ones(())
    for convert in (lambda: float(x), lambda: int(x * 3),
                    lambda: bool(x > 0), lambda: x.item(),
                    lambda: torch.ones((2,)).tolist(),
                    lambda: torch.ones((2,)).numpy(),
                    lambda: np.asarray(torch.ones((2,))),
                    lambda: complex(x), lambda: [0, 1][x.long()]):
        with pytest.raises(ImplicitHostSyncError, match="sync_free"):
            with runtime.sync_free():
                convert()


def test_sync_free_allows_explicit_device_get():
    with runtime.sync_free():
        host = runtime.device_get(torch.ones((4,)))
        nested = runtime.device_get({"a": torch.zeros((2,)),
                                     "b": (torch.ones(()), 3)})
        wide = runtime.device_get(torch.ones((2,), dtype=torch.bfloat16))
    assert isinstance(host, np.ndarray) and host.sum() == 4.0
    assert nested["a"].shape == (2,) and nested["b"][1] == 3
    assert float(nested["b"][0]) == 1.0
    assert wide.dtype == np.float32


def test_sync_free_restores_conversions_after_region():
    x = torch.ones(())
    own = {name: name in torch.Tensor.__dict__
           for name in runtime._CONVERSIONS}
    with runtime.sync_free():
        pass
    assert float(x) == 1.0 and x.item() == 1.0 and bool(x)
    assert torch.ones(2).tolist() == [1.0, 1.0]
    assert own == {name: name in torch.Tensor.__dict__
                   for name in runtime._CONVERSIONS}


def test_sync_free_nesting_keeps_guard_active():
    with runtime.sync_free():
        with runtime.sync_free():
            pass
        # inner exit must not tear down the outer region's guard
        with pytest.raises(ImplicitHostSyncError):
            float(torch.ones(()))
    assert float(torch.ones(())) == 1.0


def test_explicit_sections_are_counted():
    before = TR.explicit_counts["drain"]
    with runtime.sync_free():
        runtime.device_get(torch.ones(()))
        with TR.explicit("setup"):
            assert float(torch.ones(())) == 1.0
    assert TR.explicit_counts["drain"] == before + 1


def test_guarded_is_sync_free():
    with pytest.raises(ImplicitHostSyncError):
        with runtime.guarded():
            torch.ones(()).item()
    with runtime.guarded():
        y = torch.ones(()) + 1
        host = runtime.device_get(y)
    assert host == 2.0


# ---------------------------------------------------------------------------
# pytest plugin: markers + fixture, in a run of its own
# ---------------------------------------------------------------------------

PLUGIN_TESTS = '''
import pytest
import torch

from repro_torch.analysis.runtime import ImplicitHostSyncError, device_get


@pytest.mark.torch_sync_free
def test_sync_free_marker_is_enforced():
    with pytest.raises(ImplicitHostSyncError):
        float(torch.ones(()))
    assert device_get(torch.ones(())) == 1.0


@pytest.mark.torch_runtime_guard
def test_runtime_guard_marker_is_enforced():
    with pytest.raises(ImplicitHostSyncError):
        torch.ones(()).item()


def test_runtime_guard_fixture_scopes_a_region(torch_runtime_guard):
    x = torch.ones(())
    with torch_runtime_guard.sync_free():
        y = x + 1
        host = torch_runtime_guard.device_get(y)
    # outside the region plain casts work again
    assert float(host) == 2.0 and float(y) == 2.0


def test_unmarked_tests_read_freely():
    assert torch.ones(()).item() == 1.0


@pytest.mark.torch_runtime_guard
def test_an_implicit_read_fails_a_marked_test():
    float(torch.ones(()))
'''


def test_markers_and_fixture_are_enforced(tmp_path):
    (tmp_path / "test_guarded.py").write_text(PLUGIN_TESTS)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "repro_torch.analysis.pytest_plugin", "--strict-markers",
         "-rf", str(tmp_path / "test_guarded.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    out = res.stdout + res.stderr
    assert "1 failed, 4 passed" in out, out
    assert "FAILED test_guarded.py::test_an_implicit_read_fails_a_marked_test" \
        in out and "ImplicitHostSyncError" in out, out


# ---------------------------------------------------------------------------
# trainer hot path: sync-free modulo the explicit drains, against JAX's
# ---------------------------------------------------------------------------

DENSE = dict(
    name="guard-llama", arch_type="dense", num_layers=4, d_model=32,
    num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=128, max_seq_len=32,
    dtype="float32", param_dtype="float32")
SSM = dict(
    name="guard-mamba", arch_type="ssm", num_layers=4, d_model=32,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=128, max_seq_len=32,
    dtype="float32", param_dtype="float32")
SSM_BLOCK = dict(state_dim=8, head_dim=8, expand=2, conv_width=2,
                 chunk_size=8, ngroups=1)
FAMILIES = {"dense": DENSE, "ssm": SSM}


def configs(family, jax_side):
    fields = dict(FAMILIES[family])
    if family == "ssm":
        fields["ssm"] = (JSSMConfig if jax_side else SSMConfig)(**SSM_BLOCK)
    return (JModelConfig if jax_side else ModelConfig)(**fields)


class ForcedSchedule:
    def __init__(self, events):
        self._events = dict(events)

    def at(self, step):
        return self._events.get(step, [])


def train_config(pkg, strategy, window, steps):
    O, R, T = ((JOptimizerConfig, JRecoveryConfig, JTrainConfig)
               if pkg == "jax" else
               (OptimizerConfig, RecoveryConfig, TrainConfig))
    return T(global_batch=4, microbatch=4, seq_len=32, steps=steps,
             eval_every=100, fuse_window=window,
             optimizer=O(lr=1e-3, total_steps=steps, warmup_steps=2),
             recovery=R(strategy=strategy, num_stages=4))


def run_pair(family="dense", *, strategy="none", window=8, steps=16,
             events=None):
    """The JAX trainer under JAX's sync_free and the port's trainer under
    the port's, from JAX's initial parameters on the same batches."""
    jcfg, cfg = configs(family, True), configs(family, False)
    jtrainer = JTrainer(jax_build_model(jcfg),
                        train_config("jax", strategy, window, steps),
                        schedule=ForcedSchedule(events) if events else None)
    with jruntime.sync_free():
        _, jhist = jtrainer.run(jax_make_batches(jcfg, batch=4, seq=32,
                                                 seed=0))
    params = params_from_numpy(
        jax.tree.map(np.asarray,
                     jax_build_model(jcfg).init(jax.random.PRNGKey(0))),
        device="cpu")
    trainer = Trainer(Model(cfg, device="cpu", weights=False),
                      train_config("torch", strategy, window, steps),
                      schedule=ForcedSchedule(events) if events else None)
    drains = TR.explicit_counts["drain"]
    with runtime.sync_free():
        _, hist = trainer.run(make_batches(cfg, batch=4, seq=32, seed=0),
                              params=params)
    return jtrainer, jhist, trainer, hist, \
        TR.explicit_counts["drain"] - drains


def same_history(hist, jhist):
    assert hist.failures == [tuple(f) for f in jhist.failures]
    assert hist.dispatches == jhist.dispatches
    assert hist.wall_iters == jhist.wall_iters and hist.steps == jhist.steps
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)


def test_hot_path_is_sync_free_modulo_window_drain():
    """The fused loop's only device->host traffic is the explicit drain,
    one a window: the whole run passes under the implicit-read guard."""
    _, jhist, _, hist, drains = run_pair()
    assert hist.wall_iters == 16
    assert hist.dispatches == 2          # two full windows of 8
    assert len(hist.loss) == 16          # drained metrics all arrived
    assert np.isfinite(hist.loss).all()
    assert drains == 2                   # one drain a window
    same_history(hist, jhist)


def test_hot_path_sync_free_with_recovery_strategy():
    """CheckFree recovery (failure at step 5) stays inside the guard too:
    the merge stays on the device, its error reaches the host through the
    explicit drain."""
    _, jhist, _, hist, drains = run_pair(strategy="checkfree", steps=10,
                                         events={5: [1]})
    assert hist.failures == [(5, 1)]
    assert len(hist.recovery_errors) == 1
    assert hist.wall_iters == 10
    # the windows' drains and the recovery error's
    assert drains == hist.dispatches + 1
    same_history(hist, jhist)
    np.testing.assert_allclose([e for _, e in hist.recovery_errors],
                               [e for _, e in jhist.recovery_errors],
                               rtol=1e-3)


def test_eager_loop_is_sync_free_modulo_its_reads():
    """fuse_window=1: each eager step drains lr_scale and the loss."""
    _, jhist, _, hist, drains = run_pair(strategy="checkfree", window=1,
                                         steps=8, events={5: [1]})
    assert hist.dispatches == hist.wall_iters == 8
    assert drains == 2 * 8 + 1
    same_history(hist, jhist)


# ---------------------------------------------------------------------------
# capture sentinel: one graph per stage partition (none on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_capture_count_per_partition(family):
    jtrainer, _, trainer, _, _ = run_pair(family)
    assert trainer.dispatched_buckets == jtrainer.dispatched_buckets == {8}
    assert runtime.captured_graph_count(trainer) == 0     # nothing captured
    runtime.assert_capture_bound(trainer, 0, what=f"{family} window")


def test_capture_count_ignores_truncated_windows():
    """A mid-window failure forces shorter window sizes; JAX compiles one
    executable for each, the port replays one graph for all of them."""
    jtrainer, _, trainer, _, _ = run_pair(strategy="checkfree", steps=10,
                                          events={3: [1]})
    assert len(trainer.dispatched_buckets) > 1   # 8 plus truncation sizes
    assert trainer.dispatched_buckets == jtrainer.dispatched_buckets
    runtime.assert_capture_bound(trainer, 0)


def test_capture_bound_fails_on_extra_capture():
    _, _, trainer, _, _ = run_pair()
    with pytest.raises(AssertionError, match="silent re-captures"):
        runtime.assert_capture_bound(trainer, 1)


def test_capture_count_carries_over_a_relayout():
    """A re-layout's new window counts the old windows' captures."""
    cfg = configs("dense", False)
    window = FusedWindow(lambda *a: None, torch.device("cpu"),
                         StagePartition(cfg, 4))
    window.captures = 1
    new = window.relayout(StagePartition(cfg, 2))
    new.captures = 1
    assert new.prior_captures == 1

    class Holder:
        pass

    holder = Holder()
    holder.window = new
    assert runtime.captured_graph_count(holder) == 2
