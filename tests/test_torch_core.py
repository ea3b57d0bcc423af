"""The training core of the port against the JAX package's, on the CPU.

Stage partition (slicing, omega, re-layout helpers), the swap schedule, the
failure schedule, the wall-clock model, History, the registry, the recovery
math for every reinit and the merge-family strategies.  The same numpy
inputs go to both packages; values are held at fp32 1e-5 (the merge is one
multiply-add per element; the norms sum in different orders), events and
integers exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RecoveryConfig as JRecoveryConfig
from repro.configs import get_config as jax_get_config
from repro.core import failures as JF
from repro.core import recovery as JRec
from repro.core import stages as JS
from repro.core import swap as JSw
from repro.core import walltime as JW
from repro.core.state import History as JHistory, TrainState as JTrainState
from repro.models.model import build_model as jax_build_model
from repro.optim.adam import init_adam as jax_init_adam
from repro.recovery import FailureContext as JContext
from repro.recovery import make_strategy as jax_make_strategy
from repro_torch import tree as TR
from repro_torch.config import RecoveryConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import failures as F
from repro_torch.core import recovery as Rec
from repro_torch.core import stages as S
from repro_torch.core import swap as Sw
from repro_torch.core import walltime as W
from repro_torch.core.state import History, TrainState
from repro_torch.optim.adam import init_adam
from repro_torch.recovery import (FailureContext, available_strategies,
                                  default_protect_edges, get_strategy_cls,
                                  make_strategy)

TOL = dict(atol=1e-5, rtol=1e-5)
MINI = dict(name="paper-llama-124m-mini", num_layers=8, d_model=128,
            num_heads=4, num_kv_heads=4, d_ff=344, vocab_size=512,
            max_seq_len=64, dtype="float32")
LAYOUTS = [None, (3, 2, 3), (1, 3, 3, 1)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mini():
    """(port cfg, JAX cfg, JAX params as numpy) of the reduced paper-LLaMA."""
    jcfg = jax_get_config("paper-llama-124m").replace(**MINI)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return (get_config("paper-llama-124m").replace(**MINI), jcfg,
            jax.tree.map(np.asarray, jparams))


def both(tree_np):
    """The same numpy tree as port tensors and as JAX arrays."""
    return (params_from_numpy(tree_np, device="cpu"),
            jax.tree.map(jnp.asarray, tree_np))


def parts(cfg, jcfg, layout):
    k = 4 if layout is None else len(layout)
    return (S.StagePartition(cfg, k, layer_counts=layout),
            JS.StagePartition(jcfg, k, layer_counts=layout))


def close_trees(t, j, **tol):
    for a, b in zip(TR.leaves(t), jax.tree.leaves(j)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers,stages", [(8, 4), (24, 6), (7, 3), (5, 5)])
def test_balanced_counts_and_bounds_match_jax(mini, layers, stages):
    cfg, jcfg, _ = mini
    assert S.balanced_layer_counts(layers, stages) == \
        JS.balanced_layer_counts(layers, stages)
    cfg, jcfg = cfg.replace(num_layers=layers), jcfg.replace(num_layers=layers)
    p, jp = S.StagePartition(cfg, stages), JS.StagePartition(jcfg, stages)
    assert [p.stage_bounds(i) for i in range(stages)] == \
        [jp.stage_bounds(i) for i in range(stages)]
    assert [p.stage_of_layer(i) for i in range(layers)] == \
        [jp.stage_of_layer(i) for i in range(layers)]
    assert (p.uniform, p.layers_per_stage) == (jp.uniform, jp.layers_per_stage)
    assert S.towers(cfg) == JS.towers(jcfg)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_get_and_set_stage_match_jax(mini, layout):
    cfg, jcfg, tree = mini
    part, jpart = parts(cfg, jcfg, layout)
    tp, jp = both(tree)
    for i in range(part.num_stages):
        view = part.get_stage(tp, i)
        close_trees(view, jpart.get_stage(jp, i), atol=0, rtol=0)
        assert view["attn"]["wq"].data_ptr() == \
            tp["blocks"]["attn"]["wq"][part.stage_bounds(i)[0]].data_ptr()
    src = jax.tree.map(lambda a: np.full_like(a, 0.5),
                       jpart.get_stage(jp, 1))
    want = jpart.set_stage(jp, 1, src)
    out = part.set_stage(tp, 1, TR.map(torch.from_numpy, src))
    assert out is tp
    close_trees(tp, want, atol=0, rtol=0)
    assert part.stage0_keys(tp) == jpart.stage0_keys(jp)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_stage_grad_sqnorms_match_jax(mini, layout):
    cfg, jcfg, tree = mini
    part, jpart = parts(cfg, jcfg, layout)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), tree)
    tg, jg = both(grads)
    got = part.stage_grad_sqnorms(tg)
    assert got.shape == (part.num_stages,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpart.stage_grad_sqnorms(jg)), **TOL)


@pytest.mark.parametrize("old,new", [((2, 2, 2, 2), (3, 3, 2)),
                                     ((3, 3, 2), (2, 2, 2, 2)),
                                     ((4, 4), (1, 3, 3, 1))])
def test_relayout_helpers_match_jax(mini, old, new):
    cfg, jcfg, _ = mini
    po, jpo = parts(cfg, jcfg, old)
    pn, jpn = parts(cfg, jcfg, new)
    vals = np.arange(1, len(old) + 1, dtype=np.float32) * 1.5
    np.testing.assert_allclose(
        S.remap_stage_stats(po, pn, torch.from_numpy(vals)).numpy(),
        np.asarray(JS.remap_stage_stats(jpo, jpn, jnp.asarray(vals))), **TOL)
    assert S.remap_stage_stats(po, pn, None) is None
    slots_o, slots_n = list(range(len(old))), [0, 2, 3, 5][:len(new)]
    if len(slots_n) < len(new):
        slots_n = list(range(len(new)))
    assert S.moved_layers(po, slots_o, pn, slots_n) == \
        JS.moved_layers(jpo, slots_o, jpn, slots_n)


@pytest.mark.parametrize("stages", [2, 3, 4, 6])
def test_swap_permutation_matches_jax(stages):
    assert Sw.stage_permutations(stages) == JSw.stage_permutations(stages)
    np.testing.assert_array_equal(Sw.swap_permutation(stages * 2, stages),
                                  JSw.swap_permutation(stages * 2, stages))
    bounds = [(0, 1)] + [(i, i + 2) for i in range(1, 2 * stages - 3, 2)]
    bounds.append((bounds[-1][1], bounds[-1][1] + 1))
    n = bounds[-1][1]
    np.testing.assert_array_equal(
        Sw.swap_permutation(n, stages, bounds=bounds),
        JSw.swap_permutation(n, stages, bounds=bounds))


# ---------------------------------------------------------------------------
# failure schedule, wall clock, history, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,stages,protect", [(0.10, 4, True),
                                                 (0.10, 4, False),
                                                 (2.0, 6, False),
                                                 (0.5, 3, True)])
def test_failure_schedule_events_match_jax(rate, stages, protect):
    kw = dict(rate_per_hour=rate, iteration_time_s=600.0, num_stages=stages,
              steps=160, seed=42, protect_edges=protect)
    ours, theirs = F.FailureSchedule(**kw), JF.FailureSchedule(**kw)
    assert [(e.step, e.stage) for e in ours.events] == \
        [(e.step, e.stage) for e in theirs.events]
    assert all(ours.at(s) == theirs.at(s) for s in range(160))
    assert len(ours) == len(theirs) and ours.summary() == theirs.summary()


def test_wall_clock_model_matches_jax():
    ours, theirs = W.WallClockModel(model_bytes=123456), \
        JW.WallClockModel(model_bytes=123456)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert {k: dataclasses.asdict(v) for k, v in ours.tier_specs().items()} \
        == {k: dataclasses.asdict(v) for k, v in theirs.tier_specs().items()}
    assert ours.ckpt_save_time_s() == theirs.ckpt_save_time_s()
    assert ours.stage_bytes(4) == theirs.stage_bytes(4)
    assert ours.relayout_time_s(1e9) == theirs.relayout_time_s(1e9)
    for name in ("none", "redundant", "checkfree", "checkfree_plus"):
        assert ours.iteration_cost(name) == theirs.iteration_cost(name)
        assert ours.failure_cost(name) == theirs.failure_cost(name)


def test_history_json_round_trip_matches_jax():
    kw = dict(steps=[1, 2], wall_time=[91.3, 182.6], loss=[6.5, 6.4],
              eval_loss=[(2, 182.6, 6.3)], failures=[(1, 2)],
              recovery_errors=[(1, 12.5)], wall_iters=2, dispatches=2)
    ours = History(**kw)
    assert ours.to_json() == JHistory(**kw).to_json()
    back = History.from_json(ours.to_json())
    assert back == ours and back.eval_loss == [(2, 182.6, 6.3)]


def test_registry_matches_jax_for_the_ported_strategies():
    ported = {"none", "redundant", "checkfree", "checkfree_plus", "uniform",
              "copy", "random", "checkpoint", "tiered_ckpt", "neighbor",
              "adaptive", "elastic"}
    assert set(available_strategies()) == ported
    for name in ported:
        cls, jcls = get_strategy_cls(name), type(
            jax_make_strategy(JRecoveryConfig(strategy=name)))
        for flag in ("handles_edge_stages", "handles_consecutive",
                     "uses_swap_schedule", "recover_by_repartition"):
            assert getattr(cls, flag) == getattr(jcls, flag), (name, flag)
        assert default_protect_edges(name) == (not jcls.uses_swap_schedule)
        s, js = make_strategy(RecoveryConfig(strategy=name)), \
            jax_make_strategy(JRecoveryConfig(strategy=name))
        assert (s.iteration_cost(), s.failure_cost()) == \
            (js.iteration_cost(), js.failure_cost())
        assert s.replay_horizon() == js.replay_horizon(), name
        assert [s.after_step_horizon(k) for k in range(12)] == \
            [js.after_step_horizon(k) for k in range(12)], name
    # an adaptive instance advertises repartitioning whatever its children,
    # as JAX's; its class reports the conservative default
    for low in ("checkfree", "elastic"):
        rcfg = dict(strategy="adaptive", adaptive_low=low)
        assert make_strategy(RecoveryConfig(**rcfg)).recover_by_repartition \
            == jax_make_strategy(JRecoveryConfig(**rcfg)) \
            .recover_by_repartition is True
    assert get_strategy_cls("elastic").recover_by_repartition


# ---------------------------------------------------------------------------
# recovery math
# ---------------------------------------------------------------------------

def omegas_pair(k, seed=5):
    om = np.random.default_rng(seed).uniform(0.5, 3.0, k).astype(np.float32)
    return torch.from_numpy(om), jnp.asarray(om)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("reinit,failed", [
    ("grad_norm", 1), ("grad_norm", 2), ("uniform", 1), ("copy_prev", 2),
    ("copy_prev", 0), ("twin_copy", 0), ("twin_copy", -1), ("grad_norm", 0),
    ("uniform", -1)])
def test_recover_stage_matches_jax(mini, layout, reinit, failed):
    cfg, jcfg, tree = mini
    part, jpart = parts(cfg, jcfg, layout)
    failed %= part.num_stages
    tp, jp = both(tree)
    om, jom = omegas_pair(part.num_stages)
    before = TR.clone(tp)
    want = JRec.recover_stage(jp, jpart, failed, jom, strategy=reinit)
    got = Rec.recover_stage(tp, part, failed, om, strategy=reinit)
    assert got is tp
    close_trees(tp, want)
    np.testing.assert_allclose(
        float(Rec.recovery_error(before, tp, part, failed)),
        float(JRec.recovery_error(jax.tree.map(jnp.asarray, tree), want,
                                  jpart, failed)), rtol=1e-5)


def test_random_reinit_changes_only_the_failed_stage(mini):
    cfg, _, tree = mini
    part = S.StagePartition(cfg, 4)
    tp, _ = both(tree)
    before = TR.clone(tp)
    gen = torch.Generator().manual_seed(3)
    Rec.recover_stage(tp, part, 2, torch.ones(4), strategy="random",
                      generator=gen)
    for i in range(4):
        for a, b in zip(TR.leaves(part.get_stage(tp, i)),
                        TR.leaves(part.get_stage(before, i))):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b) == (i != 2)
    stage = torch.cat([x.flatten() for x in
                       TR.leaves(part.get_stage(tp, 2))])
    assert abs(float(stage.std()) - 0.02) < 1e-3
    for key in part.stage0_keys(tp):
        for a, b in zip(TR.leaves(tp[key]), TR.leaves(before[key])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("layout", [None, (2, 1, 2, 1, 2)])
@pytest.mark.parametrize("run", [[1, 2], [0, 1], [2, 3], [1, 2, 3]])
def test_recover_consecutive_matches_jax(mini, layout, run):
    cfg, jcfg, tree = mini
    part, jpart = parts(cfg, jcfg, layout)
    tp, jp = both(tree)
    om, jom = omegas_pair(part.num_stages, seed=6)
    want = JRec.recover_consecutive(jp, jpart, run, jom)
    Rec.recover_consecutive(tp, part, run, om)
    close_trees(tp, want)


@pytest.mark.parametrize("name,events", [
    ("checkfree", [[2]]), ("checkfree", [[0]]), ("checkfree_plus", [[3]]),
    ("checkfree_plus", [[1, 2]]), ("uniform", [[1]]), ("copy", [[2]]),
    ("checkfree", [[1], [2, 3]])])
def test_merge_strategies_match_jax(mini, name, events):
    """A strategy's whole reaction: the recovered parameters, the stage's
    zeroed moments, the capped lr boost and the recorded errors."""
    cfg, jcfg, tree = mini
    part, jpart = S.StagePartition(cfg, 4), JS.StagePartition(jcfg, 4)
    rcfg = dict(strategy=name, num_stages=4, lr_boost_cap=1.15)
    s = make_strategy(RecoveryConfig(**rcfg)).bind(part)
    js = jax_make_strategy(JRecoveryConfig(**rcfg))
    js.bind(jpart)
    tp, jp = both(tree)
    om, jom = omegas_pair(4, seed=7)
    ones = jax.tree.map(lambda a: np.ones_like(a), tree)
    tm, jm = both(ones)
    state = TrainState(tp, init_adam(tp)._replace(m=tm), 1.0, om, 3)
    jstate = JTrainState(jp, jax_init_adam(jp)._replace(m=jm), 1.0, jom, 3)
    hist, jhist = History(), JHistory()
    for step, run in enumerate(events):
        ev = FailureContext(stage=run[0], wall_step=step,
                            generator=torch.Generator(), hist=hist)
        jev = JContext(stage=run[0], wall_step=step,
                       key=jax.random.PRNGKey(0), hist=jhist)
        if len(run) > 1:
            state = s.handle_consecutive(state, run, ev)
            jstate = js.handle_consecutive(jstate, run, jev)
        else:
            state = s.handle_failure(state, ev)
            jstate = js.handle_failure(jstate, jev)
    close_trees(state.params, jstate.params)
    close_trees(state.opt_state.m, jstate.opt_state.m, atol=0, rtol=0)
    assert state.lr_scale == pytest.approx(jstate.lr_scale, rel=1e-7)
    assert [s_ for s_, _ in hist.recovery_errors] == \
        [s_ for s_, _ in jhist.recovery_errors]
    np.testing.assert_allclose([e for _, e in hist.recovery_errors],
                               [e for _, e in jhist.recovery_errors], rtol=1e-5)
