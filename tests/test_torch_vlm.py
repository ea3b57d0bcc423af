"""The VLM family (internvl2-76b's backbone) in the port, against the JAX
package, on the CPU.

Model level, on the reduced config (2 layers, d_model 256, GQA 4/2 of 64, 8
patches) with JAX's parameters carried over by the converter, fp32: the
projector (the tanh GELU that ``jax.nn.gelu`` defaults to), the full forward
(logits over the P + S positions), prefill with the patches' prefix (logits
and the K/V of P + S positions) and four teacher-forced decode steps, greedy
generation, at 1e-4 (tests/test_torch_model.py says why); ``Model.loss``
(the P patch positions dropped) and every gradient leaf, in order and with
the tower in CheckFree+'s swapped order (4 layers), against ``jax.grad`` at
1e-4 of each leaf's largest |g|.

Slice level: the port's ``Trainer`` with ``checkfree`` and ``checkfree_plus``
against the JAX trainer at ``fuse_window`` 1 and 8 (4 layers in 4 stages),
under a forced schedule that fails an intermediate stage, two at once and
the last (edge) stage: equal failures and traces, losses at 1e-4 relative,
recovery errors at 1e-3 relative, eval losses (the patch positions dropped)
at 1e-4; the port's windows 1 and 8 give the same bits.  The launchers on
the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro import configs as JCS
from repro.core.stages import StagePartition as JPart
from repro.core.trainer import Trainer as JTrainer
from repro.core.trainer import _permute_tower
from repro.data.pipeline import SyntheticLM as JSource
from repro.data.pipeline import batch_for as jax_batch_for
from repro.data.pipeline import make_batches as jax_make_batches
from repro.models import vlm as JV
from repro.models.model import build_model as jax_build_model
from repro_torch import config as C
from repro_torch import configs as CS
from repro_torch import tree as TR
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.stages import StagePartition
from repro_torch.core.swap import swap_permutation
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import (D_PATCH, SyntheticLM, batch_for,
                                       make_batches)
from repro_torch.launch import serve, train
from repro_torch.models import vlm as V
from repro_torch.models.model import Model

ARCH = "internvl2-76b"
TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL, RECOVERY_RTOL = 1e-4, 1e-3
GRAD_REL = 1e-4          # each model gradient leaf, of its largest |g|
STAGES, BATCH, SEQ, STEPS = 4, 4, 24, 12
EVENTS = {2: [1], 5: [1, 2], 9: [3]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(**kw):
    """(JAX config, port config): reduced internvl2, fp32 unless ``kw`` says
    otherwise."""
    kw = {"dtype": "float32", **kw}
    return (JCS.reduced(JCS.get_config(ARCH)).replace(**kw),
            CS.reduced(CS.get_config(ARCH)).replace(**kw))


def pair(**kw):
    """(port model, JAX model, JAX params) on the same weights, on the CPU."""
    jcfg, cfg = configs(**kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return Model(cfg, tparams, device="cpu"), jmodel, jparams


def batches(cfg, jcfg, b, s, seed=0):
    """The same numpy batch (tokens, labels, patches) for both packages."""
    raw = SyntheticLM(cfg.vocab_size, seed=5).sample(
        np.random.default_rng(seed), b, s)
    tb = batch_for(cfg, raw, np.random.default_rng(seed + 1))
    jb = jax_batch_for(jcfg, raw, np.random.default_rng(seed + 1))
    for k in tb:
        np.testing.assert_array_equal(tb[k], jb[k])
    return ({k: torch.from_numpy(v) for k, v in tb.items()},
            {k: jnp.asarray(v) for k, v in jb.items()})


def close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------

def test_project_is_the_tanh_gelu_of_jax():
    """``jax.nn.gelu`` defaults to the tanh form: the port's projector
    matches it, and the exact form would not."""
    model, jmodel, jparams = pair()
    assert D_PATCH == JV.D_PATCH == 1024
    tb, jb = batches(model.cfg, jmodel.cfg, 2, 4)
    got = V.project(model.params, tb["patches"], model.cfg)
    want = np.asarray(JV.project(jparams, jb["patches"], jmodel.cfg))
    assert got.shape == (2, 8, 256)
    close(got, want)
    p = model.params["projector"]
    exact = torch.nn.functional.gelu(tb["patches"] @ p["w1"]) @ p["w2"]
    assert not np.allclose(exact.numpy(), want, **TOL)


def test_forward_matches_jax():
    model, jmodel, jparams = pair()
    tb, jb = batches(model.cfg, jmodel.cfg, 2, 12, seed=2)
    logits, aux = model.apply(tb)
    jlogits, _ = jmodel.apply(jparams, jb)
    assert logits.shape == (2, 8 + 12, model.cfg.vocab_size)
    assert float(aux) == 0.0
    close(logits, jlogits)


def test_prefill_and_teacher_forced_decode_match_jax():
    model, jmodel, jparams = pair()
    tb, jb = batches(model.cfg, jmodel.cfg, 2, 11, seed=3)
    logits, cache = model.prefill(tb, 26)
    jlogits, jcache = jmodel.prefill(jparams, jb, 26)
    assert logits.shape == (2, 1, model.cfg.vocab_size)
    assert cache["pos"].tolist() == [19, 19]       # 8 patches + 11 tokens
    close(logits, jlogits)

    def same_cache(cache, jcache):
        close(cache["k"], jcache["k"])
        close(cache["v"], jcache["v"])
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))

    same_cache(cache, jcache)
    for _ in range(4):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(cache,
                                          torch.from_numpy(np.array(nxt)))
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt)
        close(logits, jlogits)
        same_cache(cache, jcache)


def test_greedy_generation_matches_jax():
    """``generate`` sizes the cache for the patches, the prompt and the new
    tokens, as JAX's launcher does."""
    model, jmodel, jparams = pair()
    tb, jb = batches(model.cfg, jmodel.cfg, 3, 10, seed=4)
    got = serve.generate(model, {k: tb[k] for k in ("tokens", "patches")},
                         new_tokens=6)
    logits, cache = jmodel.prefill(jparams, jb, 8 + 10 + 6)
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    want = [nxt]
    for _ in range(5):
        logits, cache = jmodel.decode_step(jparams, cache, nxt)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        want.append(nxt)
    np.testing.assert_array_equal(got.tokens,
                                  np.stack([np.asarray(t) for t in want], 1))


def test_bf16_prefill_close_to_jax():
    """bf16 compute from the same fp32 weights: within 0.05 of the largest
    |logit| (tests/test_smoke_archs.py's bf16 limit)."""
    model, jmodel, jparams = pair(dtype="bfloat16")
    tb, jb = batches(model.cfg, jmodel.cfg, 2, 9, seed=5)
    logits, _ = model.prefill(tb, 20)
    jlogits, _ = jmodel.prefill(jparams, jb, 20)
    want = np.asarray(jlogits, np.float32)
    err = np.abs(logits.float().numpy() - want).max()
    assert err <= 0.05 * np.abs(want).max()


def test_converter_round_trips_the_whole_tree():
    """Both packages' VLM trees cross ``convert`` leaf for leaf, bf16 bit
    for bit, the projector included."""
    jcfg, cfg = configs(param_dtype="bfloat16")
    jparams = jax.tree.map(np.asarray,
                           jax_build_model(jcfg).init(jax.random.PRNGKey(1)))
    tparams = params_from_numpy(jparams, device="cpu")
    back = params_to_numpy(tparams)
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jleaves) == len(TR.leaves(tparams))
    for path, leaf in jleaves:
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        np.testing.assert_array_equal(got.view(np.uint16),
                                      leaf.view(np.uint16))
    own = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    assert TR.map(lambda t: tuple(t.shape), own) == TR.map(
        lambda t: tuple(t.shape), tparams)


def loss_and_grads_pair(order):
    jcfg, cfg = configs(num_layers=4)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tb, jb = batches(cfg, jcfg, 2, 12, seed=6)

    def jloss(p):
        if order is not None:
            p = _permute_tower(p, "blocks", jnp.asarray(order))
        return jmodel.loss(p, jb)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = TR.map(lambda t: t.requires_grad_(), params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    loss, metrics = Model(cfg, device="cpu", weights=False).loss(
        params, tb, order=order)
    loss.backward()
    return (float(jl), jm, jg), (loss, metrics, params)


def close_rel(got, want, rel, name=""):
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


@pytest.mark.parametrize("swapped", [False, True])
def test_model_loss_and_gradients_match_jax(swapped):
    """``swapped``: CheckFree+'s order of 4 one-layer stages against JAX's
    permuted ``blocks``; the projector's gradient comes through the
    patches' positions, whose logits carry no loss."""
    order = swap_permutation(4, 4).tolist() if swapped else None
    (jl, jm, jg), (loss, metrics, params) = loss_and_grads_pair(order)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    jleaves = {tuple(k.key for k in path): np.asarray(v) for path, v in
               jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(TR.leaves_with_path(params))
    assert set(got) == set(jleaves)
    assert ("projector", "w1") in got
    for path, leaf in got.items():
        assert leaf.grad is not None, path
        close_rel(leaf.grad.numpy(), jleaves[path], GRAD_REL, "/".join(path))


def test_vlm_stages_its_blocks_and_replicates_the_projector():
    jcfg, cfg = configs(num_layers=4)
    part, jpart = StagePartition(cfg, 2), JPart(jcfg, 2)
    assert part.tower_key == jpart.tower_key == "blocks"
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    assert part.stage0_keys(params) == jpart.stage0_keys(jparams)
    assert "projector" in part.stage0_keys(params)
    flags = part.tower_flags(params)
    paths = [path for path, _ in TR.leaves_with_path(params)]
    assert [p[0] == "blocks" for p in paths] == flags and any(flags)


# ---------------------------------------------------------------------------
# the Trainer against the JAX trainer
# ---------------------------------------------------------------------------

class Forced:
    def __init__(self, events):
        self.events = dict(events)

    def at(self, step):
        return list(self.events.get(step, []))


def train_configs(pkg, strategy, window, tmp, name):
    rcfg = pkg.RecoveryConfig(strategy=strategy, num_stages=STAGES,
                              protect_edge_stages=False,
                              checkpoint_dir=str(tmp / f"{name}_ckpt"),
                              store_dir=str(tmp / f"{name}_store"))
    return pkg.TrainConfig(global_batch=BATCH, microbatch=BATCH, seq_len=SEQ,
                           steps=STEPS, eval_every=6, fuse_window=window,
                           optimizer=pkg.OptimizerConfig(
                               lr=1e-3, total_steps=STEPS, warmup_steps=2),
                           recovery=rcfg)


def eval_sets(jcfg, cfg):
    jsrc = JSource(cfg.vocab_size, seed=1234)
    src = SyntheticLM(cfg.vocab_size, seed=1234)
    jrng, rng = np.random.default_rng(7), np.random.default_rng(7)
    return ([jax_batch_for(jcfg, jsrc.sample(jrng, BATCH, SEQ), jrng)],
            [batch_for(cfg, src.sample(rng, BATCH, SEQ), rng)])


def port_run(strategy, window, tmp, params, evals):
    _, cfg = configs(num_layers=4)
    trainer = Trainer(Model(cfg, device="cpu", weights=False),
                      train_configs(C, strategy, window, tmp,
                                    f"torch{window}"),
                      schedule=Forced(EVENTS))
    state, hist = trainer.run(make_batches(cfg, batch=BATCH, seq=SEQ, seed=0),
                              evals, params=TR.clone(params))
    return trainer, state, hist


@pytest.mark.parametrize("strategy", ["checkfree", "checkfree_plus"])
@pytest.mark.parametrize("window", [1, 8])
def test_trainer_matches_jax(strategy, window, tmp_path):
    jcfg, cfg = configs(num_layers=4)
    jmodel = jax_build_model(jcfg)
    jevals, evals = eval_sets(jcfg, cfg)
    jtrainer = JTrainer(jmodel, train_configs(JC, strategy, window, tmp_path,
                                              "jax"),
                        schedule=Forced(EVENTS))
    _, jhist = jtrainer.run(jax_make_batches(jcfg, batch=BATCH, seq=SEQ,
                                             seed=0), eval_batches=jevals)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        device="cpu")
    trainer, state, hist = port_run(strategy, window, tmp_path, params, evals)
    assert state.effective_step == STEPS
    assert [tuple(f) for f in hist.failures] == \
        [tuple(f) for f in jhist.failures] == [(2, 1), (5, 1), (5, 2), (9, 3)]
    assert hist.steps == jhist.steps
    assert hist.wall_iters == jhist.wall_iters
    assert hist.dispatches == jhist.dispatches
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    assert [s for s, _ in hist.recovery_errors] == \
        [s for s, _ in jhist.recovery_errors]
    np.testing.assert_allclose([e for _, e in hist.recovery_errors],
                               [e for _, e in jhist.recovery_errors],
                               rtol=RECOVERY_RTOL)
    assert [s for s, _, _ in hist.eval_loss] == \
        [s for s, _, _ in jhist.eval_loss] != []
    np.testing.assert_allclose([e for _, _, e in hist.eval_loss],
                               [e for _, _, e in jhist.eval_loss],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("strategy", ["checkfree", "checkfree_plus"])
def test_windows_1_and_8_give_the_same_bits(strategy, tmp_path):
    jcfg, cfg = configs(num_layers=4)
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(3))
    _, evals = eval_sets(jcfg, cfg)
    (_, s1, h1), (_, s8, h8) = [port_run(strategy, w, tmp_path, params, evals)
                                for w in (1, 8)]
    assert h1.dispatches > h8.dispatches
    assert h1.loss == h8.loss and h1.failures == h8.failures
    assert h1.recovery_errors == h8.recovery_errors
    for x, y in zip(TR.leaves(s1.params), TR.leaves(s8.params)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launchers_train_and_serve_on_the_cpu():
    """``launch.train`` with CheckFree+ and ``launch.serve``, both reduced
    on the CPU."""
    hist = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--strategy", "checkfree_plus", "--steps", "4",
                       "--seq", "16", "--batch", "2", "--rate", "0",
                       "--quiet"])
    assert len(hist.loss) == 4 and np.isfinite(hist.loss).all()
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--new-tokens", "3"])
    assert res.tokens.shape == (2, 3)
