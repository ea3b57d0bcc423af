"""Training at 4,096 tokens (the dry-run's train_4k) in the port, against the
JAX package, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
        tests/test_torch_train_4k.py

Model level: ``Model.loss(remat=True)`` under ``REPRO_REMAT`` "nothing" and
every gradient leaf of small models (2 layers, d_model 64, two heads of
16, fp32, JAX parameters through the converter) at 4,096 tokens against JAX's,
the loss at 1e-4 relative and each leaf within 1e-4 of its largest |g|:
a dense GQA model whose window masks (4,160 tokens over a window of 4,096,
and a window of 1,024 at 4,096), an MoE model routing each row as one
group of 4,096 (every layer's top-k experts and kept choices equal to
JAX's, integer for integer), an SSM over 64 chunks of 64 and the hybrid.
The SSM and hybrid models take decays of at most 4 x dt a token (``a_log``
= log(linspace(1, 4, H)) in place of the init's linspace(1, 16, H)): at
the init's range JAX's SSD gradient is NaN over a chunk of 64 (ROADMAP.md
section 3, known divergences inside the reference).

Slice level: the port's ``Trainer`` (3 layers, d_model 32, 3 stages, 2
steps, the middle stage merged at the second) at 2 x 4,096 tokens under
``checkfree`` and ``checkfree_plus`` with one merge, at ``fuse_window`` 1
and 8, against JAX's eager trainer: equal failures, losses at 1e-4
relative, recovery errors at 1e-3 relative (tests/test_torch_trainer.py
says why).

Kernel level: the port's plain attention backward at 4,160 tokens with a
window of 4,096 (which masks) against ``jax.vjp`` of
``repro.kernels.ref.flash_attention_ref`` at 1e-5 of each gradient's
largest |g|, and ``flash_attention_bwd_groups_ref`` (a kv head's group at
a time, chip_smoke's plain backward past PLAIN_ROWS_BYTES) equal to the
whole ``flash_attention_bwd_ref`` bit for bit.

The dry-run: the ``--mesh 1x1`` estimate's argument bytes at train_4k
equal to what a real model's fp32 masters, Adam's state and a batch hold
on the CPU, for every family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro import configs as JCS
from repro.config import OptimizerConfig as JOpt
from repro.config import RecoveryConfig as JRec
from repro.config import TrainConfig as JTrain
from repro.core.trainer import Trainer as JTrainer
from repro.data.pipeline import SyntheticLM as JSource
from repro.data.pipeline import batch_for as jax_batch_for
from repro.data.pipeline import make_batches as jax_make_batches
from repro.kernels import ref as JR
from repro.models import moe as JM
from repro.models.model import build_model as jax_build_model
from repro_torch import config as C
from repro_torch import configs as CS
from repro_torch import tree as TR
from repro_torch.config import (INPUT_SHAPES, OptimizerConfig,
                                RecoveryConfig, TrainConfig)
from repro_torch.convert import params_from_numpy
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import SyntheticLM, batch_for, make_batches
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as DR
from repro_torch.models import moe as M
from repro_torch.models.model import Model

LOSS_RTOL, GRAD_REL, RECOVERY_RTOL = 1e-4, 1e-4, 1e-3
ATTN_GRAD_REL = 1e-5

# (arch, sequence, config changes) of the model-level cases
FAMILIES = {
    "dense_window_masks": ("h2o-danube-3-4b", 4160,
                           dict(sliding_window=4096)),
    "dense_window_1024": ("h2o-danube-3-4b", 4096,
                          dict(sliding_window=1024)),
    "moe_one_group": ("granite-moe-3b-a800m", 4096, {}),
    "ssm_64_chunks": ("mamba2-1.3b", 4096, {}),
    "hybrid": ("zamba2-2.7b", 4096, {}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, so that test workers running in parallel do
    not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(arch, seq, changes, pkg):
    """A 2-layer fp32 model of ``arch`` at width 64 in ``pkg`` (the JAX or
    the port's config modules), ``seq`` positions."""
    cfg_mod, configs = pkg
    cfg = configs.get_config(arch)
    kw = dict(name=f"{arch}-4k", num_layers=2, d_model=64, vocab_size=128,
              max_seq_len=seq, dtype="float32", **changes)
    if cfg.arch_type != "ssm":
        kw.update(num_heads=2, num_kv_heads=1 if cfg.num_kv_heads <
                  cfg.num_heads else 2, head_dim=16, d_ff=128)
    if cfg.arch_type == "moe":
        kw["moe"] = cfg_mod.MoEConfig(num_experts=4, top_k=2, d_ff_expert=32)
    if cfg.arch_type in ("ssm", "hybrid"):
        kw["ssm"] = cfg_mod.SSMConfig(state_dim=16, head_dim=16, expand=2,
                                      conv_width=4, chunk_size=64, ngroups=1)
    if cfg.arch_type == "hybrid":
        kw["attn_every"] = 2
    return cfg.replace(**kw)


def mild_decay(jparams):
    """JAX's parameters with every SSM layer's ``a_log`` at log(linspace(1,
    4, H)) (the module docstring says why)."""
    def fix(path, leaf):
        if path and getattr(path[-1], "key", None) == "a_log":
            h = leaf.shape[-1]
            return jnp.broadcast_to(jnp.log(jnp.linspace(1.0, 4.0, h)),
                                    leaf.shape).astype(leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fix, jparams)


def pair(family):
    arch, seq, changes = FAMILIES[family]
    jcfg = small(arch, seq, changes, (JC, JCS))
    cfg = small(arch, seq, changes, (C, CS))
    jmodel = jax_build_model(jcfg)
    jparams = mild_decay(jmodel.init(jax.random.PRNGKey(0)))
    raw = SyntheticLM(cfg.vocab_size, seed=5).sample(
        np.random.default_rng(6), 1, seq)
    jbatch = {k: jnp.asarray(v) for k, v in jax_batch_for(jcfg, raw).items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch_for(cfg, raw).items()}
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, jbatch, Model(cfg, device="cpu", weights=False), \
        params, tbatch


def close_rel(got, want, rel, name=""):
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_gradients_at_4096_tokens_match_jax(family, monkeypatch):
    monkeypatch.setenv("REPRO_REMAT", "nothing")
    jmodel, jparams, jbatch, model, params, tbatch = pair(family)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, remat=True), has_aux=True))(jparams)
    params = TR.map(lambda t: t.requires_grad_(), params)
    loss, _ = model.loss(params, tbatch, remat=True)
    grads = torch.autograd.grad(loss, TR.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    jleaves = {tuple(k.key for k in path): np.asarray(v) for path, v in
               jax.tree_util.tree_flatten_with_path(jg)[0]}
    paths = [p for p, _ in TR.leaves_with_path(params)]
    assert set(paths) == set(jleaves)
    for path, g in zip(paths, grads):
        assert np.isfinite(jleaves[path]).all(), path
        close_rel(g.numpy(), jleaves[path], GRAD_REL, "/".join(path))


def test_moe_routes_each_row_of_4096_as_jax(monkeypatch):
    """Every MoE layer's routing of the forward, one group of 4,096 a row:
    top-k experts and kept choices equal to JAX's (read off its one-hot
    dispatch, its layer scan unrolled so that each layer runs on its
    own)."""
    monkeypatch.setenv("REPRO_UNROLL_SCAN", "1")
    jmodel, jparams, jbatch, model, params, tbatch = pair("moe_one_group")
    got, want = [], []
    route, dispatch = M.route, JM.topk_dispatch

    def port_recorded(p, xg, cfg, cap):
        r = route(p, xg, cfg, cap)
        got.append((r.topi.numpy(), r.keep.numpy()))
        return r

    def jax_recorded(gates, k, capacity, dtype):
        out = dispatch(gates, k, capacity, dtype)
        _, topi = jax.lax.top_k(gates, k)
        topi = np.asarray(topi)
        placed = np.asarray(out[0], np.float32).sum(-1)      # (G, T, E)
        want.append((topi, np.take_along_axis(placed, topi, -1) > 0))
        return out

    monkeypatch.setattr(M, "route", port_recorded)
    monkeypatch.setattr(JM, "topk_dispatch", jax_recorded)
    with torch.no_grad():
        loss, _ = model.loss(params, tbatch)
    jl, _ = jmodel.loss(jparams, jbatch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    cfg = model.cfg
    assert [t.shape for t, _ in want] == [(1, 4096, cfg.moe.top_k)] * 2
    assert len(got) == len(want) == cfg.num_layers
    for (gt, gk), (wt, wk) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gk, wk)
        assert not wk.all()            # the slots fill: some choices drop


# ---------------------------------------------------------------------------
# the Trainer at 2 x 4,096 tokens
# ---------------------------------------------------------------------------

MINI = dict(name="paper-llama-1.5b-4k", num_layers=3, d_model=32,
            num_heads=1, num_kv_heads=1, d_ff=64, vocab_size=128,
            max_seq_len=4096, dtype="float32")
STAGES, BATCH, SEQ, STEPS = 3, 2, 4096, 2
FORCED = {1: [1]}


class Forced:
    def __init__(self, events):
        self.events = events

    def at(self, step):
        return list(self.events.get(step, []))


def train_configs(strategy, window, O, R, T):
    return T(global_batch=BATCH, microbatch=BATCH, seq_len=SEQ, steps=STEPS,
             eval_every=STEPS, fuse_window=window,
             optimizer=O(lr=6e-4, total_steps=STEPS),
             recovery=R(strategy=strategy, num_stages=STAGES,
                        protect_edge_stages=False))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's eager trainer, once a strategy: {strategy: History}."""
    jcfg = JCS.get_config("paper-llama-1.5b").replace(**MINI)
    out = {}
    for strategy in ("checkfree", "checkfree_plus"):
        jmodel = jax_build_model(jcfg)
        trainer = JTrainer(jmodel, train_configs(strategy, 1, JOpt, JRec,
                                                 JTrain),
                           schedule=Forced(FORCED))
        _, out[strategy] = trainer.run(jax_make_batches(
            jcfg, batch=BATCH, seq=SEQ, seed=0, source=JSource(128, seed=1)))
    return out


@pytest.mark.parametrize("window", [1, 8])
@pytest.mark.parametrize("strategy", ["checkfree", "checkfree_plus"])
def test_trainer_at_4096_tokens_matches_jax(strategy, window, jax_runs):
    jcfg = JCS.get_config("paper-llama-1.5b").replace(**MINI)
    cfg = CS.get_config("paper-llama-1.5b").replace(**MINI)
    params = params_from_numpy(jax.tree.map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0))),
        device="cpu")
    trainer = Trainer(Model(cfg, device="cpu", weights=False),
                      train_configs(strategy, window, OptimizerConfig,
                                    RecoveryConfig, TrainConfig),
                      schedule=Forced(FORCED))
    state, hist = trainer.run(make_batches(cfg, batch=BATCH, seq=SEQ, seed=0,
                                           source=SyntheticLM(128, seed=1)),
                              params=params)
    jhist = jax_runs[strategy]
    assert [tuple(f) for f in hist.failures] == \
        [tuple(f) for f in jhist.failures] == [(1, 1)]
    assert hist.steps == jhist.steps and state.effective_step == STEPS
    assert hist.dispatches == (STEPS if window == 1 else 2)
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    assert [s for s, _ in hist.recovery_errors] == \
        [s for s, _ in jhist.recovery_errors] == [1]
    np.testing.assert_allclose([e for _, e in hist.recovery_errors],
                               [e for _, e in jhist.recovery_errors],
                               rtol=RECOVERY_RTOL)


# ---------------------------------------------------------------------------
# the plain backward at 4,160 tokens with a window of 4,096
# ---------------------------------------------------------------------------

def qkv_do(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
             (b, hq, sq, d))]


def test_plain_backward_with_a_masking_window_matches_jax_vjp():
    q, k, v, do = qkv_do(0, 1, 2, 1, 4160, 4160, 16)
    _, vjp = jax.vjp(lambda q, k, v: JR.flash_attention_ref(
        q, k, v, causal=True, window=4096), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=True, window=4096)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, True, 4096)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        close_rel(g.numpy(), np.asarray(w), ATTN_GRAD_REL, name)
    # the window masks: the first query's keys no longer reach the last
    # row, so the last row's dq differs from the causal gradient's
    full = ref.flash_attention_bwd_ref(tq, tk, tv, *ref.flash_attention_ref(
        tq, tk, tv, causal=True, window=0), tdo, True, 0)
    assert not torch.allclose(got[0][:, :, -1], full[0][:, :, -1])
    assert torch.equal(got[0][:, :, :4096], full[0][:, :, :4096])


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", [
    (2, 8, 2, 96, 96, 16, True, 0),        # GQA
    (1, 6, 1, 80, 80, 32, True, 33),       # MQA, a window
    (2, 4, 4, 70, 70, 16, True, 64),       # MHA, a window that masks
    (1, 6, 3, 37, 90, 16, False, 0),       # cross-attention
    (1, 14, 2, 96, 96, 16, True, 0),       # deepseek-coder-33b's group of 7
    (1, 7, 1, 70, 70, 16, True, 33),       # the same, MQA, a window
])
def test_grouped_plain_backward_equals_the_whole(b, hq, hkv, sq, sk, d,
                                                 causal, window):
    tq, tk, tv, tdo = map(torch.from_numpy,
                          qkv_do(1, b, hq, hkv, sq, sk, d))
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                       window=window)
    whole = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal,
                                        window)
    grouped = ref.flash_attention_bwd_groups_ref(tq, tk, tv, out, lse, tdo,
                                                 causal, window)
    for g, w in zip(grouped, whole):
        assert g.shape == w.shape and torch.equal(g, w)


# ---------------------------------------------------------------------------
# the one-card estimate's arguments at train_4k
# ---------------------------------------------------------------------------

def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("arch", ["qwen3-4b", "h2o-danube-3-4b",
                                  "granite-moe-3b-a800m", "mamba2-1.3b",
                                  "zamba2-2.7b", "whisper-large-v3",
                                  "internvl2-76b", "deepseek-moe-16b",
                                  "deepseek-coder-33b", "gemma-2b"])
def test_train_4k_estimate_holds_the_bytes_of_the_real_state(arch):
    """fp32 masters, Adam's m, v and step count, and the batch (int32
    tokens and labels; frames and patches in the compute dtype), as
    chip_smoke's train_remat builds them on the card."""
    cfg = CS.reduced(CS.get_config(arch))
    batch, seq = 2, 64 + (cfg.num_patches if cfg.arch_type == "vlm" else 0)
    rec = DR.run_one(arch, "train_4k", mesh="1x1", cfg=cfg, batch=batch,
                     seq=seq, with_cost=False, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    plan = DR.plan_for(cfg, INPUT_SHAPES["train_4k"], batch=batch, seq=seq)
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in TR.leaves(params))
    state = DR.init_state(params)
    raw = next(make_batches(cfg, batch=batch, seq=plan["text"], seed=0))
    data = {k: torch.as_tensor(v) for k, v in raw.items()}
    for k in ("frames", "patches"):
        if k in data:
            data[k] = data[k].to(getattr(torch, cfg.dtype))
    assert set(data) == set(DR.batch_inputs(cfg, plan, batch))
    held = (nbytes(TR.leaves(params)) + nbytes(state.m) + nbytes(state.v)
            + nbytes([state.step]) + nbytes(data.values()))
    assert rec["memory"]["argument_B"] == held
