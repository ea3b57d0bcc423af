"""The serving slice of the port against the JAX package, end to end.

Reduced paper-llama-124m (MHA), reduced qwen3-4b (GQA 4/2, qk-norm, rope
theta 1e6), and reduced gemma-2b (MQA, GeGLU, tied and scaled embeddings)
and h2o-danube-3-4b (GQA, sliding window 4096) at their real head dims 256
and 120, in fp32: JAX parameters go through the converter, prompts are
drawn with numpy, and prefill (logits and the whole KV cache), four decode
steps teacher-forced with JAX's tokens, full greedy generation and the full
forward are held to the JAX model.  Tolerance 1e-4: both frameworks compute
in fp32 but sum in different orders, and the differences grow through the
layers and the vocabulary projection.  bf16 is held to 0.05 of the largest
|logit|, as in tests/test_smoke_archs.py.  Also here: configs, the synthetic
data source, the converter, the package's isolation from JAX and the
absence of a silent CPU fallback.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JCF
from repro import configs as JC
from repro.data import pipeline as JD
from repro.models.model import build_model as jax_build_model
from repro_torch import config as TC
from repro_torch import configs as C
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import pipeline as D
from repro_torch.launch import serve
from repro_torch.models.model import Model, build_model

TOL = dict(atol=1e-4, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the families whose reduced configs keep their real head dim, which
# ``reduced`` would set to 64
REAL_HEAD_DIM = ("gemma-2b", "h2o-danube-3-4b")
PARITY_ARCHS = ["paper-llama-124m", "qwen3-4b", *REAL_HEAD_DIM]


def pair(arch, **kw):
    """(port model, JAX model, JAX params) on the same weights, on the CPU."""
    if arch in REAL_HEAD_DIM:
        kw = dict(head_dim=C.get_config(arch).head_dim, **kw)
    jcfg = JC.reduced(JC.get_config(arch)).replace(**kw)
    cfg = C.reduced(C.get_config(arch)).replace(**kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return build_model(cfg, tparams, device="cpu"), jmodel, jparams


def prompt(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL)


def close_cache(cache, jcache):
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def jax_greedy(jmodel, jparams, toks, new_tokens, window=0):
    capacity = window or toks.shape[1] + new_tokens
    logits, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   capacity)
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    out = [nxt]
    for _ in range(new_tokens - 1):
        logits, cache = jmodel.decode_step(jparams, cache, nxt, window=window)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        out.append(nxt)
    return np.stack([np.asarray(t) for t in out], axis=1)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

def test_every_config_matches_jax():
    ids = sorted(JC.ARCHS) + sorted(JC.PAPER_MODELS)
    assert ids == sorted(C.ARCHS) + sorted(C.PAPER_MODELS)
    for name in ids:
        cfg, jcfg = C.get_config(name), JC.get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert dataclasses.asdict(C.reduced(cfg)) == \
            dataclasses.asdict(JC.reduced(jcfg)), name
        assert cfg.param_count() == jcfg.param_count(), name
        assert C.get_stages(name) == JC.get_stages(name), name
        assert cfg.is_decoder_only == jcfg.is_decoder_only, name
        assert cfg.to_json() == jcfg.to_json(), name
    assert C.arch_ids() == JC.arch_ids()
    assert dataclasses.asdict(TC.ServeConfig()) == \
        dataclasses.asdict(JCF.ServeConfig())
    assert {k: dataclasses.asdict(v) for k, v in TC.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JCF.INPUT_SHAPES.items()}


def test_synthetic_source_matches_jax():
    for arch in ("paper-llama-124m", "whisper-large-v3", "internvl2-76b"):
        cfg = C.reduced(C.get_config(arch))
        src, jsrc = D.SyntheticLM(512, seed=7), JD.SyntheticLM(512, seed=7)
        raw = src.sample(np.random.default_rng(3), 3, 20)
        np.testing.assert_array_equal(
            raw, jsrc.sample(np.random.default_rng(3), 3, 20))
        got = D.batch_for(cfg, raw, np.random.default_rng(4))
        want = JD.batch_for(JC.reduced(JC.get_config(arch)), raw,
                            np.random.default_rng(4))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the slice against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_prefill_and_teacher_forced_decode_match_jax(arch):
    model, jmodel, jparams = pair(arch, dtype="float32")
    toks = prompt(model.cfg, 2, 12)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, 20)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 20)
    assert logits.shape == (2, 1, model.cfg.vocab_size)
    close(logits, jlogits)
    close_cache(cache, jcache)
    for _ in range(4):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(cache,
                                          torch.from_numpy(np.array(nxt)))
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt)
        close(logits, jlogits)
        close_cache(cache, jcache)


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_greedy_generation_matches_jax(arch):
    model, jmodel, jparams = pair(arch, dtype="float32")
    toks = prompt(model.cfg, 3, 10, seed=1)
    got = serve.generate(model, torch.from_numpy(toks), new_tokens=8)
    assert got.tokens.shape == (3, 8) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens,
                                  jax_greedy(jmodel, jparams, toks, 8))


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_forward_matches_jax(arch):
    model, jmodel, jparams = pair(arch, dtype="float32")
    toks = prompt(model.cfg, 2, 16, seed=2)
    logits, aux = model.apply({"tokens": torch.from_numpy(toks)})
    jlogits, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(toks)})
    assert logits.shape == (2, 16, model.cfg.vocab_size)
    assert float(aux) == 0.0
    close(logits, jlogits)


def test_ragged_prompt_matches_jax():
    """37 tokens: no multiple of any tile of the flash kernel."""
    model, jmodel, jparams = pair("qwen3-4b", dtype="float32")
    toks = prompt(model.cfg, 2, 37, seed=3)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, 40)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 40)
    close(logits, jlogits)
    close_cache(cache, jcache)


def test_swa_ring_cache_matches_jax():
    """Prompt 12 into a ring of capacity 8 == sliding window, then ring decode
    (transformer.py:215-224 and layers.py:208-214 of the JAX package)."""
    model, jmodel, jparams = pair("paper-llama-124m", dtype="float32",
                                  sliding_window=8)
    toks = prompt(model.cfg, 2, 12, seed=4)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, 8)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 8)
    close(logits, jlogits)
    close_cache(cache, jcache)
    for _ in range(5):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(
            cache, torch.from_numpy(np.array(nxt)), window=8)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt, window=8)
        close(logits, jlogits)
        close_cache(cache, jcache)
    got = serve.generate(model, torch.from_numpy(toks), new_tokens=6, window=8)
    np.testing.assert_array_equal(
        got.tokens, jax_greedy(jmodel, jparams, toks, 6, window=8))


def test_bf16_prefill_and_forward_close_to_jax():
    model, jmodel, jparams = pair("qwen3-4b")          # dtype bfloat16
    assert model.params["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    toks = prompt(model.cfg, 2, 12, seed=5)
    logits, _ = model.prefill({"tokens": torch.from_numpy(toks)}, 16)
    jlogits, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    full, _ = model.apply({"tokens": torch.from_numpy(toks)})
    jfull, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(toks)})
    for got, want in ((logits, jlogits), (full, jfull)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err / (np.abs(want).max() + 1e-6) < 0.05, err


# ---------------------------------------------------------------------------
# converter, model facade, isolation, no fallback
# ---------------------------------------------------------------------------

def test_converter_bf16_round_trip():
    jmodel = jax_build_model(JC.reduced(JC.get_config("qwen3-4b")))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                        jmodel.init(jax.random.PRNGKey(1)))
    tparams = params_from_numpy(tree, device="cpu")
    assert tparams["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert tparams["blocks"]["attn"]["wq"].shape == \
        tree["blocks"]["attn"]["wq"].shape
    back = params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def test_model_owns_parameters_in_jax_layout():
    cfg = C.reduced(C.get_config("qwen3-4b"))
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    assert isinstance(model, torch.nn.Module)
    wq = model.state_dict()["tree.blocks.attn.wq"]
    assert wq.shape == (2, cfg.d_model, cfg.num_heads * cfg.resolved_head_dim)
    assert wq.dtype == torch.bfloat16
    assert model.params["blocks"]["attn"]["q_norm"]["scale"].shape == (2, 64)
    init = model.init(torch.Generator().manual_seed(0))
    assert init["embed"]["table"].dtype == torch.float32
    std = float(init["blocks"]["mlp"]["w_down"].std())
    assert abs(std * np.sqrt(cfg.d_ff) - 0.987) < 0.02   # cut at 3 sigma


def test_package_imports_no_jax_and_nothing_of_repro():
    code = (
        "import glob, importlib, importlib.util, os, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    if not m.name.endswith('.__main__'):   # a CLI: runs on import\n"
        "        importlib.import_module(m.name)\n"
        "scripts = ['chip_smoke.py', *sorted(glob.glob("
        "'examples/torch_*.py'))]\n"
        "assert len(scripts) == 6, scripts\n"
        "for path in scripts:\n"
        "    name = os.path.basename(path)[:-3]\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "for m in ('launch.serve', 'launch.train', 'core.trainer', "
        "'core.recovery', 'core.stages', 'core.failures', 'core.walltime', "
        "'recovery', 'recovery.base', 'recovery.strategies', "
        "'optim.adam', 'kernels.stage_merge', "
        "'models.ssm', 'models.hybrid', 'models.moe', 'models.encdec', "
        "'models.vlm', 'kernels.ssd_scan', "
        "'statestore', "
        "'statestore.codec', 'statestore.tiers', 'statestore.store', "
        "'statestore.snapshot', 'statestore.policy', 'statestore.faults', "
        "'statestore.strategies', 'ckpt', 'ckpt.checkpoint', "
        "'recovery.adaptive', 'data.pipeline', 'sim', 'sim.node', "
        "'sim.scenario', 'sim.processes', 'sim.cluster', 'sim.adapters', "
        "'telemetry', 'telemetry.events', 'telemetry.recorder', "
        "'telemetry.trace', 'telemetry.metrics', 'telemetry.report', "
        "'telemetry.log', 'pipeline', 'pipeline.spmd', "
        "'pipeline.transport', 'launch.mesh', 'launch.perf', "
        "'launch.shardings', 'launch.dryrun', 'kernels.cost', "
        "'analysis', 'analysis.engine', 'analysis.rules', "
        "'analysis.baseline', 'analysis.cli', 'analysis.runtime', "
        "'analysis.pytest_plugin'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "paper-llama-124m", "--reduced"])


def test_serve_cli_on_cpu():
    res = serve.main(["--arch", "qwen3-4b", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--new-tokens", "3"])
    assert res.tokens.shape == (2, 3)
