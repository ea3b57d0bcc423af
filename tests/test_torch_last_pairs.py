"""The dry-run's last (arch x shape) pairs that one card runs, on the CPU,
against the JAX package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
        tests/test_torch_last_pairs.py

Kernel level: deepseek-coder-33b's GQA group of 7 (56/8 heads), which the
backward kernels sum dK and dV over: the port's plain backward at 14/2 and
7/1 heads (causal, and a window that masks) against ``jax.vjp`` of
``repro.kernels.ref.flash_attention_ref`` at ATTN_GRAD_REL (1e-5) of each
gradient's largest |g|, and JAX's Pallas backward kernels in interpret mode
at the same shapes against the port's plain backward at
tests/test_torch_flash_bwd.py's 2e-4.

Model level, train_4k's plans cut in width (``Model.loss(remat=True)``
under REPRO_REMAT "nothing", fp32, JAX parameters through the converter):
the loss at LOSS_RTOL (1e-4) relative and each gradient leaf within
GRAD_REL (1e-4) of its largest |g|, as tests/test_torch_train_4k.py holds
the other families:
  * deepseek-coder-33b, 2 layers, 7/1 heads of 16 (its group of 7), 2,048
    tokens (16 key blocks of 128);
  * deepseek-moe-16b, 2 layers at d 64 with its 64 routed experts, top-6
    and 2 shared experts, one row of 4,096 routed as one group: every
    layer's top-k experts and kept choices equal to JAX's, and the loss
    and gradients;
  * internvl2-76b, 2 layers at d 64: its 256 patches before 3,840 tokens,
    as the dry-run's train_4k plans 4,096 positions.

Decode across 2^19 (long_500k's positions) from a ring cache against JAX,
given JAX's jitted RoPE frequencies (tests/test_torch_long_context.py says
why), at 1e-4: gemma-2b's MQA at head dim 256 and granite-moe-3b-a800m's
routed decode.

chip_smoke's ``remat_depth``: the depth its search (``DR.deepest_fit``)
picks equals a walk down from the published depth, over every model that
train_remat runs, with a stubbed estimate that grows linearly in depth and
one with a step in it.

``ByteCorpus`` in the port: the same seed gives JAX's crops of a local
text file, and the same batches through ``make_batches(source=...)``.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_long_context import LONG_POS, jax_jit_rope_freqs
from test_torch_model import close, close_cache, pair, prompt
from test_torch_train_4k import (ATTN_GRAD_REL, GRAD_REL, LOSS_RTOL,
                                 close_rel, one_torch_thread, qkv_do)
from repro import config as JC
from repro import configs as JCS
from repro.data import pipeline as JP
from repro.kernels import ref as JR
from repro.kernels.flash_attention import _bwd_call, _fwd_call
from repro.models import moe as JM
from repro.models.model import build_model as jax_build_model
from repro_torch import config as C
from repro_torch import configs as CS
from repro_torch import data as TD
from repro_torch import tree as TR
from repro_torch.config import INPUT_SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as DR
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model import Model

assert one_torch_thread                      # the autouse fixture, in use here
PALLAS_TOL = dict(atol=2e-4, rtol=2e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the backward at a GQA group of 7
# ---------------------------------------------------------------------------

GROUP_7 = [(14, 2, 0), (7, 1, 0), (14, 2, 40), (7, 1, 40)]


@pytest.mark.parametrize("hq,hkv,window", GROUP_7)
def test_group_of_7_plain_backward_matches_jax_vjp(hq, hkv, window):
    q, k, v, do = qkv_do(7, 1, hq, hkv, 128, 128, 32)
    _, vjp = jax.vjp(lambda q, k, v: JR.flash_attention_ref(
        q, k, v, causal=True, window=window), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, True, window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        close_rel(g.numpy(), np.asarray(w), ATTN_GRAD_REL, name)


@pytest.mark.parametrize("hq,hkv,window", GROUP_7)
def test_group_of_7_pallas_backward_matches_the_ports_plain_version(
        hq, hkv, window):
    arrs = qkv_do(8, 1, hq, hkv, 128, 128, 32)
    jq, jk, jv, jdo = map(jnp.asarray, arrs)
    jo, jlse = _fwd_call(jq, jk, jv, True, window, 32, 32, True)
    want = _bwd_call(jq, jk, jv, jo, jlse, jdo, True, window, 32, 32, True)
    tq, tk, tv, tdo = map(torch.from_numpy, arrs)
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, True, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PALLAS_TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# train_4k's plans for the three models one card holds only cut in depth
# ---------------------------------------------------------------------------

def narrow(arch, pkg):
    """``arch`` in ``pkg`` (the JAX or the port's config modules) cut to 2
    layers at the width of these tests, fp32, and its train_4k sequence."""
    cfg_mod, configs = pkg
    cfg = configs.get_config(arch)
    kw = dict(name=f"{arch}-narrow", num_layers=2, vocab_size=128,
              dtype="float32")
    if arch == "deepseek-coder-33b":
        seq = 2048
        kw.update(d_model=112, num_heads=7, num_kv_heads=1, head_dim=16,
                  d_ff=128)
    elif arch == "deepseek-moe-16b":
        seq = 4096
        kw.update(d_model=64, num_heads=2, num_kv_heads=2, head_dim=16,
                  moe=cfg_mod.MoEConfig(num_experts=64, top_k=6,
                                        num_shared_experts=2,
                                        d_ff_expert=16))
    else:                                               # internvl2-76b
        seq = INPUT_SHAPES["train_4k"].seq_len
        kw.update(d_model=64, num_heads=2, num_kv_heads=1, head_dim=16,
                  d_ff=128)
    return cfg.replace(max_seq_len=seq, **kw), seq


def narrow_pair(arch):
    """(JAX model, its params, its batch, the port's model, the same params
    converted, the port's batch): one row of the plan's tokens (a VLM's
    text after its patches) drawn alike for both."""
    jcfg, seq = narrow(arch, (JC, JCS))
    cfg, _ = narrow(arch, (C, CS))
    plan = DR.plan_for(cfg, INPUT_SHAPES["train_4k"], batch=1, seq=seq)
    assert plan["seq"] == seq
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    raw = TD.SyntheticLM(cfg.vocab_size, seed=5).sample(
        np.random.default_rng(6), 1, plan["text"])
    jbatch = {k: jnp.asarray(v) for k, v in JP.batch_for(jcfg, raw).items()}
    tbatch = {k: torch.as_tensor(v) for k, v in TD.batch_for(cfg, raw).items()}
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, jbatch, Model(cfg, device="cpu", weights=False), \
        params, tbatch


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "deepseek-moe-16b",
                                  "internvl2-76b"])
def test_train_4k_plan_loss_and_gradients_match_jax(arch, monkeypatch):
    monkeypatch.setenv("REPRO_REMAT", "nothing")
    jmodel, jparams, jbatch, model, params, tbatch = narrow_pair(arch)
    positions = tbatch["tokens"].shape[1] + model.cfg.num_patches
    assert positions == narrow(arch, (C, CS))[1]
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


def test_deepseek_moe_routes_a_row_of_4096_as_jax(monkeypatch):
    """Each layer's routing of deepseek-moe-16b's forward over one group of
    4,096: 64 routed experts, top-6, the top-k experts and kept choices
    equal to JAX's (read off its one-hot dispatch, its layer scan unrolled
    so that each layer runs on its own)."""
    monkeypatch.setenv("REPRO_UNROLL_SCAN", "1")
    jmodel, jparams, jbatch, model, params, tbatch = narrow_pair(
        "deepseek-moe-16b")
    got, want = [], []
    route, dispatch = M.route, JM.topk_dispatch

    def port_recorded(p, xg, cfg, cap):
        r = route(p, xg, cfg, cap)
        got.append((r.topi.numpy(), r.keep.numpy()))
        return r

    def jax_recorded(gates, k, capacity, dtype):
        out = dispatch(gates, k, capacity, dtype)
        _, topi = jax.lax.top_k(gates, k)
        placed = np.asarray(out[0], np.float32).sum(-1)      # (G, T, E)
        topi = np.asarray(topi)
        want.append((topi, np.take_along_axis(placed, topi, -1) > 0))
        return out

    monkeypatch.setattr(M, "route", port_recorded)
    monkeypatch.setattr(JM, "topk_dispatch", jax_recorded)
    with torch.no_grad():
        loss, _ = model.loss(params, tbatch)
    jl, _ = jmodel.loss(jparams, jbatch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    moe = model.cfg.moe
    assert (moe.num_experts, moe.top_k, moe.num_shared_experts) == (64, 6, 2)
    assert [t.shape for t, _ in want] == [(1, 4096, 6)] * 2
    assert len(got) == len(want) == model.cfg.num_layers
    for (gt, gk), (wt, wk) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gk, wk)
        assert not wk.all()            # the slots fill: some choices drop


# ---------------------------------------------------------------------------
# decode across 2^19 from a ring: MQA at head dim 256, and an MoE model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-3b-a800m"])
def test_ring_decode_across_2_19_matches_jax(arch, monkeypatch):
    """long_500k's SWA-serving ring of 8 slots filled by a prompt of 8,
    ``pos`` set to 524,280 in both packages, then 12 greedy steps across
    2^19, with JAX's jitted RoPE frequencies carried in: logits and the
    ring's K/V at 1e-4 after every step."""
    window = 8
    monkeypatch.setattr(L, "rope_freqs", jax_jit_rope_freqs)
    model, jmodel, jparams = pair(arch, dtype="float32")
    if arch == "gemma-2b":
        assert (model.cfg.num_kv_heads, model.cfg.resolved_head_dim) == \
            (1, 256)
    else:
        assert model.cfg.arch_type == "moe"
    toks = prompt(model.cfg, 2, window, seed=9)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, window)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     window)
    close(logits, jlogits)
    cache["pos"].fill_(LONG_POS)
    jcache = dict(jcache, pos=jnp.full_like(jcache["pos"], LONG_POS))
    for _ in range(12):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(
            cache, torch.from_numpy(np.array(nxt)), window=window)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt,
                                             window=window)
        close(logits, jlogits)
        close_cache(cache, jcache)
    assert int(cache["pos"][0]) == LONG_POS + 12 > 2 ** 19


# ---------------------------------------------------------------------------
# chip_smoke's remat_depth: a few estimates give the walk's depth
# ---------------------------------------------------------------------------

def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GIB = 2 ** 30
STUBS = {
    # bytes of a depth: one layer's 7.9 GiB on 15 GiB
    "linear": lambda n: (15 + 7.9 * n) * GIB,
    # the same, and 9 GiB more from the fifth layer on
    "step": lambda n: (15 + 7.9 * n + 9 * (n >= 5)) * GIB,
}


def walked(cfg, need, free, unit):
    """The walk down from the published depth, over the depths the family
    builds at (a hybrid in segments of ``attn_every`` layers): the estimate
    grown by 10% and 3 GiB of the allocator's room."""
    for layers in range(cfg.num_layers, 0, -unit):
        if need(layers) * (1 + 0.10) + 3 * GIB <= free:
            return layers
    return 0


@pytest.fixture(scope="module")
def smoke():
    return chip_smoke()


@pytest.mark.parametrize("stub", sorted(STUBS))
@pytest.mark.parametrize("arch", ["qwen3-4b", "h2o-danube-3-4b", "gemma-2b",
                                  "mamba2-1.3b", "zamba2-2.7b",
                                  "granite-moe-3b-a800m", "whisper-large-v3",
                                  "deepseek-coder-33b", "deepseek-moe-16b",
                                  "internvl2-76b"])
def test_remat_depth_gives_the_walks_depth(arch, stub, smoke, monkeypatch):
    assert arch in smoke.REMAT_FULL
    need = STUBS[stub]
    estimated = []

    def estimate(cfg, batch, seq):
        assert (batch, seq) == (smoke.REMAT_FULL_BATCH, smoke.REMAT_FULL_SEQ)
        estimated.append(cfg.num_layers)
        return {"memory": {"peak_est_B": need(cfg.num_layers)}}

    monkeypatch.setattr(smoke, "remat_estimate", estimate)
    cfg = CS.get_config(arch)
    unit = cfg.attn_every if cfg.arch_type == "hybrid" else 1
    assert (smoke.REMAT_PEAK_TOL, smoke.REMAT_FIT_SLACK_GIB) == (0.10, 3.0)
    # budgets from none fitting to the published depth fitting
    for free_gib in [20, 30, 40.5, 60, 70.2, 79.0, 85, 150, 500, 900]:
        free = free_gib * GIB
        want = walked(cfg, need, free, unit)
        estimated.clear()
        if not want:
            with pytest.raises(AssertionError, match="no depth"):
                smoke.remat_depth(arch, free)
            continue
        got, rec, tried = smoke.remat_depth(arch, free)
        assert got.num_layers == want, (free_gib, tried)
        assert got == cfg.replace(num_layers=want)
        assert rec["memory"]["peak_est_B"] == need(want)
        assert tried == sorted(set(estimated))
        assert all(n % unit == 0 for n in estimated)
        assert len(estimated) == len(set(estimated))      # each depth once
        if stub == "linear":
            assert len(estimated) <= 4, estimated


def test_deepest_fit_refuses_no_depth():
    with pytest.raises(ValueError):
        DR.deepest_fit(lambda n: n, 0, 10)
    assert DR.deepest_fit(lambda n: 5.0, 1, 4.0) == 0
    assert DR.deepest_fit(lambda n: 5.0, 1, 5.0) == 1
    # a need that falls with depth: the guess is the published depth
    assert DR.deepest_fit(lambda n: 10.0 - n, 30, 9.5) == 30


# ---------------------------------------------------------------------------
# ByteCorpus
# ---------------------------------------------------------------------------

def test_byte_corpus_gives_jaxs_samples_and_batches(tmp_path):
    path = tmp_path / "corpus.txt"
    text = "".join(f"line {i}: the quick brown fox jumps over {i * 7} dogs\n"
                   for i in range(200))
    path.write_text(text)
    jsrc, src = JP.ByteCorpus(str(path)), TD.ByteCorpus(str(path))
    np.testing.assert_array_equal(src.data, jsrc.data)
    assert src.data.dtype == jsrc.data.dtype == np.int32
    for seed in (0, 3):
        got = src.sample(np.random.default_rng(seed), 4, 64)
        want = jsrc.sample(np.random.default_rng(seed), 4, 64)
        assert got.shape == (4, 65) and got.max() < 256
        np.testing.assert_array_equal(got, want)
    cfg = CS.reduced(CS.get_config("paper-llama-124m")).replace(
        vocab_size=256)
    jcfg = JCS.reduced(JCS.get_config("paper-llama-124m")).replace(
        vocab_size=256)
    ours = TD.make_batches(cfg, batch=3, seq=32, seed=5, source=src)
    theirs = JP.make_batches(jcfg, batch=3, seq=32, seed=5, source=jsrc)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_byte_corpus_refuses_an_empty_file(tmp_path):
    path = tmp_path / "empty.txt"
    path.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        TD.ByteCorpus(str(path))
