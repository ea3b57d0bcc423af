"""Remat in every family of the port against the JAX package, on the CPU.

``Model.loss(remat=True)`` checkpoints each family's blocks as the JAX
families do (``launch.perf``): each decoder block (dense, MoE), each mamba2
layer (ssm), each segment (hybrid), the decoder blocks alone and always
keeping nothing (encoder-decoder), the decoder's blocks (VLM).  Reduced
configs in fp32, JAX parameters through the converter: the port's loss and
gradients with remat equal JAX's with remat within the trainer's
tolerances (loss 1e-4 relative, each gradient leaf within 1e-4 of its
largest |g|) under ``REPRO_REMAT`` "nothing" and "dots" (set on both
sides); remat on and off give the same bits on the CPU; the MoE routing
recomputed in the backward equals the forward's, integer for integer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCS
from repro.data.pipeline import batch_for as jax_batch_for
from repro.models.model import build_model as jax_build_model
from repro_torch import configs as CS
from repro_torch import tree as TR
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.launch import perf
from repro_torch.models import moe as MOE
from repro_torch.models.model import Model

# one of each family
ARCHS = ["paper-llama-124m", "granite-moe-3b-a800m", "mamba2-1.3b",
         "zamba2-2.7b", "whisper-large-v3", "internvl2-76b"]
POLICIES = ["nothing", "dots"]
LOSS_RTOL, GRAD_REL = 1e-4, 1e-4
BATCH, SEQ = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(arch, configs):
    """The reduced config cut to width 64 and a vocabulary of 128, fp32."""
    cfg = configs.reduced(configs.get_config(arch)).replace(
        dtype="float32", d_model=64, vocab_size=128)
    if cfg.arch_type != "ssm":
        cfg = cfg.replace(head_dim=16, d_ff=min(cfg.d_ff, 128))
    if cfg.arch_type == "moe":
        cfg = cfg.replace(moe=cfg.moe.__class__(
            **{**cfg.moe.__dict__, "d_ff_expert": 32}))
    if cfg.arch_type in ("ssm", "hybrid"):
        cfg = cfg.replace(ssm=cfg.ssm.__class__(
            **{**cfg.ssm.__dict__, "head_dim": 16}))
    if cfg.arch_type == "vlm":
        cfg = cfg.replace(num_patches=4)
    return cfg


def batches(arch):
    jcfg, cfg = small(arch, JCS), small(arch, CS)
    seq = SEQ - (cfg.num_patches if cfg.arch_type == "vlm" else 0)
    raw = SyntheticLM(cfg.vocab_size, seed=3).sample(
        np.random.default_rng(4), BATCH, seq)
    jbatch = {k: jnp.asarray(v) for k, v in
              jax_batch_for(jcfg, raw, np.random.default_rng(5)).items()}
    tbatch = {k: torch.as_tensor(v) for k, v in
              batch_for(cfg, raw, np.random.default_rng(5)).items()}
    return jcfg, cfg, jbatch, tbatch


def port_loss(cfg, params, batch, remat):
    """(loss, aux, gradients by path) of the port's ``Model.loss``."""
    params = TR.map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, metrics = Model(cfg, device="cpu", weights=False).loss(
        params, batch, remat=remat)
    grads = torch.autograd.grad(loss, TR.leaves(params))
    paths = [p for p, _ in TR.leaves_with_path(params)]
    return loss.detach(), metrics["aux"].detach(), dict(zip(paths, grads))


def close_rel(got, want, rel, name=""):
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_gradients_match_jax(arch, policy, monkeypatch):
    monkeypatch.setenv("REPRO_REMAT", policy)
    jcfg, cfg, jbatch, tbatch = batches(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, remat=True), has_aux=True))(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    loss, _, grads = port_loss(cfg, params, tbatch, remat=True)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    jleaves = {tuple(k.key for k in path): np.asarray(v) for path, v in
               jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert set(grads) == set(jleaves)
    for path, g in grads.items():
        close_rel(g.numpy(), jleaves[path], GRAD_REL, "/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_bits(arch, monkeypatch):
    cfg = small(arch, CS)
    _, _, _, tbatch = batches(arch)
    params = Model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0)).params
    params = TR.map(lambda t: t.float(), params)
    want = port_loss(cfg, params, tbatch, remat=False)
    for policy in POLICIES:
        monkeypatch.setenv("REPRO_REMAT", policy)
        got = port_loss(cfg, params, tbatch, remat=True)
        assert torch.equal(got[0], want[0]), policy
        assert torch.equal(got[1], want[1]), policy
        for path in want[2]:
            assert torch.equal(got[2][path], want[2][path]), (policy, path)


@pytest.mark.parametrize("policy", POLICIES)
def test_moe_routing_under_remat_equals_without(policy, monkeypatch):
    """Every ``route`` call's integers (top-k experts, slots, kept) in the
    remat forward and its recompute equal those of the run without remat,
    layer by layer."""
    monkeypatch.setenv("REPRO_REMAT", policy)
    arch = "granite-moe-3b-a800m"
    cfg = small(arch, CS)
    _, _, _, tbatch = batches(arch)
    params = TR.map(lambda t: t.float(), Model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(1)).params)
    route = MOE.route
    calls = []

    def recording(*a, **kw):
        r = route(*a, **kw)
        calls.append((r.topi.clone(), r.pos.clone(), r.keep.clone()))
        return r

    monkeypatch.setattr(MOE, "route", recording)
    port_loss(cfg, params, tbatch, remat=False)
    plain = list(calls)
    calls.clear()
    port_loss(cfg, params, tbatch, remat=True)
    layers = cfg.num_layers
    assert len(plain) == layers
    # the forward's layers, then each layer again in the backward, last first
    assert len(calls) == 2 * layers
    forward, again = calls[:layers], calls[layers:][::-1]
    for i in range(layers):
        for got, re, want in zip(forward[i], again[i], plain[i]):
            assert torch.equal(got, want) and torch.equal(re, want), i


def test_remat_policy_reads_the_environment(monkeypatch):
    monkeypatch.delenv("REPRO_REMAT", raising=False)
    assert perf.remat_policy() == "nothing"
    monkeypatch.setenv("REPRO_REMAT", "dots")
    assert perf.remat_policy() == "dots"
    monkeypatch.setenv("REPRO_REMAT", "everything")
    with pytest.raises(ValueError):
        perf.remat_policy()
    with pytest.raises(ValueError):
        perf.checkpoint(lambda x: x, torch.ones(2), policy="some")
    monkeypatch.delenv("REPRO_ACT_SHARD", raising=False)
    assert perf.activation_spec() is None
    monkeypatch.setenv("REPRO_ACT_SHARD", "feature")
    assert perf.activation_spec() == (None, None, "model")
    monkeypatch.setenv("REPRO_ACT_SHARD", "seq")
    assert perf.activation_spec() == (None, "model", None)
    monkeypatch.setenv("REPRO_ACT_SHARD", "rows")
    with pytest.raises(ValueError):
        perf.activation_spec()
