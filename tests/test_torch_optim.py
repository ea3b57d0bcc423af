"""The training configs, Adam, the loss and its gradients, against JAX.

Numpy inputs go through both packages on the CPU in fp32.  Adam: one update
of params, m and v for each schedule, with clipping and the CheckFree lr
boost, at 1e-6 (the same fp32 arithmetic in both; only the order of the
norm's sum differs).  Loss and gradients of the reduced paper-LLaMA of
examples/train_with_failures.py, and of 2-layer gemma-2b and
h2o-danube-3-4b at their real head dims (256 and 120), from JAX's initial
parameters, at 1e-5 relative for the loss and 1e-4 for the gradients: the
frameworks sum the matrix products in different orders, and the
differences grow backwards through 8 layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.stages import StagePartition as JPart
from repro.core.trainer import _make_loss_fn as jax_loss_fn
from repro.models import layers as JL
from repro.models.model import build_model as jax_build_model
from repro.optim import adam as JA
from repro_torch import config as C
from repro_torch import tree as TR
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.stages import StagePartition
from repro_torch.core.trainer import make_loss_fn
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.optim import adam as A

MINI = dict(name="paper-llama-124m-mini", num_layers=8, d_model=128,
            num_heads=4, num_kv_heads=4, d_ff=344, vocab_size=512,
            max_seq_len=64, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["OptimizerConfig", "RecoveryConfig",
                                  "TrainConfig"])
def test_training_config_defaults_match_jax(name):
    ours, theirs = getattr(C, name)(), getattr(JC, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    if name == "TrainConfig":
        assert ours.num_microbatches == theirs.num_microbatches


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def tree_pair(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}
    tree = TR.map(lambda sh: (scale * rng.standard_normal(sh))
                  .astype(np.float32), shapes)
    return tree


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_jax(schedule):
    cfg = C.OptimizerConfig(schedule=schedule, warmup_steps=5, total_steps=40)
    jcfg = JC.OptimizerConfig(schedule=schedule, warmup_steps=5,
                              total_steps=40)
    for step in range(0, 45):
        want = float(JA.lr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        assert A.lr_schedule(cfg, step) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("grad_scale,lr_scale,wd", [(1.0, 1.0, 0.0),
                                                    (5.0, 1.1, 0.0),
                                                    (0.1, 1.0, 0.01)])
def test_adam_update_matches_jax(schedule, grad_scale, lr_scale, wd):
    """One step from non-zero moments at step 7: params, m, v, the global
    grad norm and the lr (clipping active at grad_scale 5)."""
    kw = dict(schedule=schedule, warmup_steps=3, total_steps=20, lr=1e-2,
              weight_decay=wd)
    cfg, jcfg = C.OptimizerConfig(**kw), JC.OptimizerConfig(**kw)
    p, g = tree_pair(0), tree_pair(1, grad_scale)
    m, v = tree_pair(2, 0.1), TR.map(np.abs, tree_pair(3, 0.01))
    jstate = JA.OptState(jax.tree.map(jnp.asarray, m),
                         jax.tree.map(jnp.asarray, v),
                         jnp.asarray(7, jnp.int32))
    jp, js, jmet = JA.adam_update(jcfg, jax.tree.map(jnp.asarray, p),
                                  jax.tree.map(jnp.asarray, g), jstate,
                                  lr_scale)
    t = lambda tree: TR.map(torch.from_numpy, TR.map(np.copy, tree))  # noqa: E731
    state = A.OptState(t(m), t(v), 7)
    tp, ts, met = A.adam_update(cfg, t(p), t(g), state, lr_scale)
    assert ts.step == 8
    for a, b in zip(TR.leaves(tp), jax.tree.leaves(jp)):
        close(a, b, atol=1e-6, rtol=1e-6)
    for a, b in zip(TR.leaves(ts.m) + TR.leaves(ts.v),
                    jax.tree.leaves(js.m) + jax.tree.leaves(js.v)):
        close(a, b, atol=1e-7, rtol=1e-6)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-6)
    assert met["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-6)


def test_adam_grad_norm_override_and_init():
    cfg, jcfg = C.OptimizerConfig(lr=1e-2), JC.OptimizerConfig(lr=1e-2)
    p, g = tree_pair(4), tree_pair(5, 3.0)
    t = lambda tree: TR.map(torch.from_numpy, TR.map(np.copy, tree))  # noqa: E731
    state = A.init_adam(t(p))
    assert state.step == 0 and all(x.dtype == torch.float32 and not x.any()
                                   for x in TR.leaves(state.m))
    jstate = JA.init_adam(jax.tree.map(jnp.asarray, p))
    jp, _, _ = JA.adam_update(jcfg, jax.tree.map(jnp.asarray, p),
                              jax.tree.map(jnp.asarray, g), jstate,
                              grad_norm=jnp.asarray(10.0))
    tp, _, met = A.adam_update(cfg, t(p), t(g), state,
                               grad_norm=torch.tensor(10.0))
    assert float(met["grad_norm"]) == 10.0
    for a, b in zip(TR.leaves(tp), jax.tree.leaves(jp)):
        close(a, b, atol=1e-6, rtol=1e-6)
    gn = A.global_norm(t(g))
    assert float(gn) == pytest.approx(float(JA.global_norm(
        jax.tree.map(jnp.asarray, g))), rel=1e-6)


def test_reset_state_subtree_matches_jax():
    m, v = tree_pair(6), tree_pair(7)
    jstate = JA.OptState(jax.tree.map(jnp.asarray, m),
                         jax.tree.map(jnp.asarray, v), jnp.asarray(3))
    jout = JA.reset_state_subtree(
        jstate, lambda path, leaf: path[0].key == "b")
    state = A.OptState(TR.map(torch.from_numpy, m),
                       TR.map(torch.from_numpy, v), 3)
    out = A.reset_state_subtree(state, lambda path, leaf: path[0] == "b")
    for a, b in zip(TR.leaves(out.m) + TR.leaves(out.v),
                    jax.tree.leaves(jout.m) + jax.tree.leaves(jout.v)):
        close(a, b, atol=0, rtol=0)
    # a tensor mask zeroes element-wise
    A.reset_state_subtree(out, lambda path, leaf: leaf > 0)
    assert all((x <= 0).all() for x in TR.leaves(out.m))


# ---------------------------------------------------------------------------
# cross-entropy, the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_values_and_grads_match_jax(masked):
    rng = np.random.default_rng(8)
    logits = (3 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, jg = jax.value_and_grad(JL.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), jmask)
    x = torch.from_numpy(logits).requires_grad_()
    got = L.cross_entropy(x, torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    close(x.grad, jg, atol=1e-7, rtol=1e-5)


def test_cross_entropy_bf16_keeps_bf16_grads():
    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((2, 5, 40))).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 5)).astype(np.int32)
    want, jg = jax.value_and_grad(JL.cross_entropy)(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels))
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    got = L.cross_entropy(x, torch.from_numpy(labels))
    got.backward()
    assert x.grad.dtype == torch.bfloat16
    assert got.item() == pytest.approx(float(want), rel=1e-3)
    close(x.grad, jg, atol=2e-3, rtol=3e-2)


# 2-layer reductions that keep each family's head dim (gemma-2b 256 with
# MQA, h2o-danube-3-4b 120 with GQA), as tests/test_torch_model.py does for
# serving; danube's window is cut to 16 so that it masks keys at S 32
REAL_HEAD_DIM = {"gemma-2b": {},
                 "h2o-danube-3-4b": {"sliding_window": 16}}


def configs(arch="paper-llama-124m-mini"):
    """(JAX config, port config) of the mini paper-LLaMA or a reduction."""
    if arch == "paper-llama-124m-mini":
        return (jax_get_config("paper-llama-124m").replace(**MINI),
                get_config("paper-llama-124m").replace(**MINI))
    kw = dict(head_dim=get_config(arch).head_dim, dtype="float32",
              **REAL_HEAD_DIM[arch])
    return (jax_reduced(jax_get_config(arch)).replace(**kw),
            reduced(get_config(arch)).replace(**kw))


def mini_pair(arch="paper-llama-124m-mini"):
    jcfg, cfg = configs(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = TR.map(lambda t: t.requires_grad_(), params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    rng = np.random.default_rng(10)
    toks = rng.integers(0, 512, size=(4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return (Model(cfg, device="cpu", weights=False), tparams, jmodel, jparams,
            batch)


def grads_close(tparams, jgrads, rtol=1e-4):
    """Each gradient leaf within rtol of its own largest entry."""
    flat = dict(TR.leaves_with_path(tparams))
    for kp, want in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        path = tuple(k.key for k in kp)
        got = flat[path].grad
        assert got is not None and got.dtype == torch.float32, path
        want = np.asarray(want)
        scale = np.abs(want).max() + 1e-12
        err = np.abs(got.numpy() - want).max()
        assert err <= rtol * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ["paper-llama-124m-mini", *REAL_HEAD_DIM])
def test_model_loss_and_grads_match_jax(arch):
    model, tparams, jmodel, jparams, batch = mini_pair(arch)
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = model.loss(tparams, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    assert metrics["ce"].item() == pytest.approx(float(jm["ce"]), rel=1e-5)
    assert float(metrics["aux"]) == 0.0
    grads_close(tparams, jg)


def test_swap_loss_and_grads_match_jax():
    """CheckFree+'s loss: half the batch through the swapped stage order,
    as a layer order (port) and as a gathered tower (JAX)."""
    model, tparams, jmodel, jparams, batch = mini_pair()
    jfn = jax_loss_fn(jmodel, JPart(jmodel.cfg, 4), use_swap=True)
    (jl, jm), jg = jax.value_and_grad(jfn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    fn = make_loss_fn(model, StagePartition(model.cfg, 4), use_swap=True)
    loss, metrics = fn(tparams, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    assert metrics["ce"].item() == pytest.approx(float(jm["ce"]), rel=1e-5)
    grads_close(tparams, jg)


def test_model_loss_casts_fp32_masters_inside_the_graph():
    """bf16 compute: the masters stay fp32 and their gradients land in fp32;
    the loss is near JAX's bf16 loss (0.5%: bf16 rounds at other places in
    the two frameworks)."""
    kw = dict(MINI, dtype="bfloat16")
    cfg = get_config("paper-llama-124m").replace(**kw)
    jmodel = jax_build_model(jax_get_config("paper-llama-124m").replace(**kw))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tparams = TR.map(lambda t: t.requires_grad_(), params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    toks = np.random.default_rng(11).integers(0, 512, size=(2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    jl, _ = jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = Model(cfg, device="cpu", weights=False).loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert loss.dtype == torch.float32
    assert loss.item() == pytest.approx(float(jl), rel=5e-3)
    for leaf in TR.leaves(tparams):
        assert leaf.dtype == torch.float32
        assert leaf.grad.dtype == torch.float32 and torch.isfinite(leaf.grad).all()


def test_weightless_model_holds_no_parameters():
    cfg = get_config("paper-llama-124m").replace(**MINI)
    model = Model(cfg, device="cpu", weights=False)
    assert not list(model.parameters())
    with pytest.raises(RuntimeError, match="weights=False"):
        model.apply({"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    params = model.init(torch.Generator().manual_seed(0))
    assert params["blocks"]["attn"]["wq"].dtype == torch.float32
