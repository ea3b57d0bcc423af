"""The port's examples (``examples/torch_*.py``) against the JAX examples,
on the CPU.

Each port example's ``main([..., "--device", "cpu"], params=...)`` runs at
its mini size, from JAX's initial parameters (``model.init(PRNGKey(0))``
through the converter) and the same seeds, beside the JAX example:

* quickstart and train_with_failures (one strategy, ``--steps`` cut):
  failure steps equal, losses within 1e-4 relative;
* spot_trace_demo (``--steps`` cut): the simulated schedule equal exactly,
  losses within 1e-4 relative;
* recovery_demo: the recovery errors of the deterministic reinits within
  1e-3 relative (``random`` draws from another generator than JAX's key,
  as ``repro_torch.core.recovery.recover_stage`` says: its error is held to
  the same order of magnitude only);
* serve_batched: the greedy tokens equal at every position up to the first
  where JAX's top-2 logit margin is 1e-4 or less (greedy decoding feeds
  each token back, so the continuations may part there).  Both run the
  example's reduced configs in fp32: in their bf16 a margin of 1e-4 is
  below the logits' rounding, and granite-moe-3b-a800m's routing, which is
  discrete, parts on the first token.

The tolerances are tests/test_torch_trainer.py's: both packages compute in
fp32 but sum the matrix products in other orders.  The JAX examples with a
``run`` function are imported and called; quickstart and recovery_demo are
scripts, run with ``runpy`` (recovery_demo's table parsed from its output,
which prints each error to five significant digits); serve_batched's loop
is repeated here to read JAX's logits, which the script does not keep.
Also here: every example refuses ``--device cuda`` without a card.
"""
import contextlib
import importlib.util
import io
import os
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.config import ModelConfig as JModelConfig
from repro.data.pipeline import SyntheticLM as JSource
from repro.data.pipeline import batch_for as jax_batch_for
from repro.models.model import build_model as jax_build_model
from repro.sim import get_scenario as jax_get_scenario
from repro_torch import configs as C
from repro_torch.convert import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
LOSS_RTOL, RECOVERY_RTOL, MARGIN = 1e-4, 1e-3, 1e-4
NAMES = ("torch_quickstart", "torch_recovery_demo", "torch_serve_batched",
         "torch_spot_trace_demo", "torch_train_with_failures")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(name):
    """An example as a module (``examples`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_init(jcfg):
    """JAX's initial parameters of ``jcfg`` and the same on the port."""
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             device="cpu")


def mini_124m():
    """The JAX examples' CPU-sized paper-llama-124m."""
    return JC.get_config("paper-llama-124m").replace(
        name="paper-llama-124m-mini", num_layers=8, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=344, vocab_size=512,
        max_seq_len=64, dtype="float32")


def same_history(hist, jhist):
    assert [tuple(f) for f in hist.failures] == \
        [tuple(f) for f in jhist.failures]
    assert hist.steps == jhist.steps
    assert hist.wall_iters == jhist.wall_iters
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    assert [s for s, _ in hist.recovery_errors] == \
        [s for s, _ in jhist.recovery_errors]


def test_quickstart_matches_jax():
    with contextlib.redirect_stdout(io.StringIO()):
        jax_run = runpy.run_path(os.path.join(EXAMPLES, "quickstart.py"))
    jhist = jax_run["hist"]
    got = load("torch_quickstart").main(
        ["--device", "cpu"], params=jax_init(jax_run["cfg"]))
    assert [tuple(f) for f in got["failures"]] == [(12, 2)] == \
        [tuple(f) for f in jhist.failures]
    assert got["steps"] == jhist.steps
    np.testing.assert_allclose(got["loss"], jhist.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose([e for _, e in got["recovery_errors"]],
                               [e for _, e in jhist.recovery_errors],
                               rtol=RECOVERY_RTOL)


def test_train_with_failures_matches_jax():
    """One strategy, 12 steps at a churn that fails stages in them."""
    steps, rate = 12, 1.0
    jmod = load("train_with_failures")
    jhist = jmod.run("checkfree", mini_124m(), 4, steps, rate, 64, 8)
    got = load("torch_train_with_failures").main(
        ["--steps", str(steps), "--rate", str(rate), "--strategies",
         "checkfree", "--device", "cpu"], params=jax_init(mini_124m()))
    hist = got["hists"]["checkfree"]
    assert jhist.failures, "the schedule should fail a stage in 12 steps"
    same_history(hist, jhist)
    np.testing.assert_allclose([e for _, e in hist.recovery_errors],
                               [e for _, e in jhist.recovery_errors],
                               rtol=RECOVERY_RTOL)
    np.testing.assert_allclose([e for _, _, e in hist.eval_loss],
                               [e for _, _, e in jhist.eval_loss],
                               rtol=LOSS_RTOL)
    assert got["rows"][0][:3] == ("checkfree", len(jhist.failures),
                                  jhist.wall_iters)


def test_spot_trace_demo_matches_jax():
    steps = 12
    jmod = load("spot_trace_demo")
    scenario = jax_get_scenario("trace:spot_demo.jsonl",
                                iteration_time_s=300.0, num_stages=4)
    jhist, jschedule = jmod.run("checkfree", mini_124m(), scenario, steps)
    got = load("torch_spot_trace_demo").main(
        ["--steps", str(steps), "--strategies", "checkfree", "--device",
         "cpu"], params=jax_init(mini_124m()))
    hist = got["hists"]["checkfree"]
    schedule = got["schedules"]["checkfree"]
    for wall in range(steps * 10):
        assert schedule.at(wall) == jschedule.at(wall), wall
        assert schedule.iteration_factor(wall) == \
            jschedule.iteration_factor(wall), wall
    assert jhist.failures, "the trace should preempt a stage in 12 steps"
    same_history(hist, jhist)
    assert hist.wall_time == pytest.approx(jhist.wall_time, rel=1e-12)


def jax_recovery_table():
    """(trained loss, {strategy: error}) from the JAX script's output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_run = runpy.run_path(os.path.join(EXAMPLES, "recovery_demo.py"))
    text = out.getvalue()
    errors = {m[1]: float(m[2]) for m in re.finditer(
        r"^(\w+)\s+([-+.\deE]+)\s+[-+.\d]+\s+[-+.\d]+", text, re.M)}
    trained = float(re.search(r"trained 40 steps, loss ([\d.]+)", text)[1])
    return jax_run["cfg"], trained, errors


def test_recovery_demo_matches_jax():
    jcfg, trained, jerrors = jax_recovery_table()
    assert set(jerrors) == {"grad_norm", "uniform", "copy_prev", "random"}
    got = load("torch_recovery_demo").main(["--device", "cpu"],
                                           params=jax_init(jcfg))
    assert got["trained_loss"] == pytest.approx(trained, abs=1e-4)
    errors = {r["strategy"]: r["error"] for r in got["rows"]}
    for strat in ("grad_norm", "uniform", "copy_prev"):
        assert errors[strat] == pytest.approx(jerrors[strat],
                                              rel=RECOVERY_RTOL), strat
    # another generator's draws: the same order of magnitude
    assert 0.5 < errors["random"] / jerrors["random"] < 2.0
    assert all(np.isfinite([r["loss_after_20"] for r in got["rows"]]))


def jax_serve(arch, batch, prompt, new):
    """JAX's serve_batched loop for one arch, in fp32: (the port's copy of
    the parameters, tokens, top-2 margins), each (batch, new)."""
    cfg = JC.reduced(JC.get_config(arch)).replace(dtype="float32")
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    src = JSource(cfg.vocab_size, seed=7)
    rng = np.random.default_rng(0)
    b = {k: jnp.asarray(v) for k, v in
         jax_batch_for(cfg, src.sample(rng, batch, prompt), rng).items()}
    # jitted, as the example's steps are
    prefill = jax.jit(lambda p, b: model.prefill(p, b, prompt + new))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, b)
    toks, margins = [], []
    for i in range(new):
        last = np.asarray(logits[:, -1], np.float32)
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        if i < new - 1:
            logits, cache = decode(params, cache, tok)
    return (params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
            np.stack(toks, 1), np.stack(margins, 1))


def test_serve_batched_matches_jax():
    mod = load("torch_serve_batched")
    mod.reduced = lambda cfg: C.reduced(cfg).replace(dtype="float32")
    runs = {arch: jax_serve(arch, mod.BATCH, mod.PROMPT, mod.NEW)
            for arch in mod.ARCHS}
    got = mod.main(["--device", "cpu"],
                   params={arch: run[0] for arch, run in runs.items()})
    assert [r["arch"] for r in got["rows"]] == mod.ARCHS
    compared = 0
    for row in got["rows"]:
        _, jtoks, margins = runs[row["arch"]]
        assert row["tokens"].shape == jtoks.shape == (mod.BATCH, mod.NEW)
        for b in range(mod.BATCH):
            clear = np.cumprod(margins[b] > MARGIN).astype(bool)
            np.testing.assert_array_equal(row["tokens"][b][clear],
                                          jtoks[b][clear],
                                          err_msg=f"{row['arch']} row {b}")
            compared += int(clear.sum())
    # most positions are decided by a clear margin
    assert compared >= 0.5 * len(mod.ARCHS) * mod.BATCH * mod.NEW


@pytest.mark.parametrize("name", NAMES)
def test_examples_refuse_cuda_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main([])


def test_examples_import_no_jax():
    """The port's examples name nothing of JAX or the JAX package."""
    for name in NAMES:
        with open(os.path.join(EXAMPLES, f"{name}.py")) as f:
            text = f.read()
        assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", text,
                             re.M), name


def test_jax_cfg_of_quickstart_is_the_ports():
    """The port's quickstart model is the JAX script's."""
    cfg = load("torch_quickstart").CFG
    jcfg = JModelConfig(
        name="quickstart-llama", arch_type="dense", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=160, vocab_size=256,
        max_seq_len=64, dtype="float32", param_dtype="float32")
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == \
        (jcfg.num_layers, jcfg.d_model, jcfg.d_ff, jcfg.vocab_size)
