"""The encoder-decoder family (whisper-large-v3) in the port, against the JAX
package, on the CPU.

Kernel level: the flash plain version at another key length than the query
length (cross-attention, full) against JAX's ``_sdpa`` with ``mask=None``,
and its backward (``flash_attention_bwd_ref``) against PyTorch's autograd,
fp32 at 2e-5 and 2e-4 (tests/test_kernels.py's tolerances); the refusal of
a causal or windowed mask over Sq != Sk.

Model level, on the reduced config (2 encoder + 2 decoder layers, d_model
256, 4 heads of 64, 16 frames) with JAX's parameters carried over by the
converter, fp32: ``encode``, the full forward, prefill (logits and every
cache tensor: self K/V and the cross K/V) and four teacher-forced decode
steps, greedy generation, at 1e-4 (tests/test_torch_model.py says why);
``Model.loss`` and every gradient leaf, in order and with the encoder's
layers in CheckFree+'s swapped order (4 encoder layers), against
``jax.grad`` at 1e-4 of each leaf's largest |g|.

Slice level: the port's ``Trainer`` with ``checkfree`` and ``checkfree_plus``
against the JAX trainer at ``fuse_window`` 1 and 8 (4 encoder layers in 4
stages: the staged tower is the encoder's, as the JAX trainer's), under a
forced schedule that fails an intermediate stage, two at once and the last
(edge) stage: equal failures and traces, losses at 1e-4 relative, recovery
errors at 1e-3 relative (tests/test_torch_trainer.py says why); the port's
windows 1 and 8 give the same bits.  The launchers on the CPU.
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
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models.model import build_model as jax_build_model
from repro_torch import config as C
from repro_torch import configs as CS
from repro_torch import tree as TR
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.stages import StagePartition
from repro_torch.core.swap import swap_permutation
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import SyntheticLM, batch_for, make_batches
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, train
from repro_torch.models import encdec as ED
from repro_torch.models.model import Model

ARCH = "whisper-large-v3"
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
    """(JAX config, port config): reduced whisper, fp32 unless ``kw`` says
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
    """The same numpy batch (tokens, labels, frames) for both packages."""
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
# the plain flash version at Sq != Sk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,hq,hkv", [(1, 37, 4, 4), (13, 16, 4, 2),
                                          (40, 9, 4, 1), (65, 150, 2, 2)])
def test_flash_ref_cross_attention_matches_jax_sdpa(sq, sk, hq, hkv):
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((2, sq, hq, 64)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, 64)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, 64)).astype(np.float32)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                    1.0 / 8.0)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=False)
    assert out.shape == (2, hq, sq, 64) and lse.shape == (2, hq, sq)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("sq,sk,hq,hkv", [(1, 37, 4, 4), (13, 16, 4, 2),
                                          (40, 9, 4, 1)])
def test_flash_bwd_ref_cross_attention_matches_autograd(sq, sk, hq, hkv):
    gen = torch.Generator().manual_seed(sq + sk)
    q = torch.randn(2, hq, sq, 64, generator=gen)
    k = torch.randn(2, hkv, sk, 64, generator=gen)
    v = torch.randn(2, hkv, sk, 64, generator=gen)
    do = torch.randn(2, hq, sq, 64, generator=gen)
    out, lse = ref.flash_attention_ref(q, k, v, causal=False)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, False, 0)
    assert dk.shape == k.shape and dv.shape == v.shape
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = ref.flash_attention_ref(*leaves, causal=False)
    for got, want in zip((dq, dk, dv), torch.autograd.grad(o, leaves, do)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                                   rtol=2e-4)


def test_ops_refuses_a_causal_or_windowed_mask_over_another_key_length():
    q = torch.zeros(1, 5, 2, 64)
    k = v = torch.zeros(1, 7, 2, 64)
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="no causal or window"):
            ops.flash_attention(q, k, v, **kw)


# ---------------------------------------------------------------------------
# the attention layer against JAX's
# ---------------------------------------------------------------------------

def layer_pair(qk_norm, kv_heads, seed):
    """(port cfg, JAX cfg, port params, JAX params) of one attention layer:
    reduced whisper's widths, with the given kv heads and qk-norm."""
    jcfg, cfg = configs(num_kv_heads=kv_heads, use_qk_norm=qk_norm)
    jp = JL.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return cfg, jcfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu"), jp


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("mode", ["cross", "full", "causal"])
def test_attention_layer_matches_jax(qk_norm, kv_heads, mode):
    """``layers.attention`` with ``kv`` (cross, another sequence's keys),
    ``causal=False`` (the encoder's) and causal, all without rope, against
    ``repro.models.layers.attention`` with ``kv``, an all-true mask and a
    causal mask; the k and v it returns too."""
    from repro_torch.models import layers as TL
    cfg, jcfg, tp, jp = layer_pair(qk_norm, kv_heads, seed=len(mode))
    rng = np.random.default_rng(kv_heads)
    x = rng.standard_normal((2, 9, 256)).astype(np.float32)
    enc = rng.standard_normal((2, 16, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9))
    kw, jkw = {}, {}
    if mode == "cross":
        kw, jkw = dict(kv=torch.from_numpy(enc)), dict(
            mask=None, kv=(jnp.asarray(enc), jnp.asarray(enc)))
    elif mode == "full":
        kw, jkw = dict(causal=False), dict(mask=jnp.ones((9, 9), bool))
    else:
        jkw = dict(mask=JL.causal_mask(9, 9))
    out, (k, v) = TL.attention(tp, torch.from_numpy(x), torch.from_numpy(
        np.ascontiguousarray(pos)), cfg, use_rope=False, return_kv=True, **kw)
    jout, (jk, jv) = JL.attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                  use_rope=False, return_kv=True, **jkw)
    assert k.shape[1] == (16 if mode == "cross" else 9)
    for got, want in ((out, jout), (k, jk), (v, jv)):
        close(got, want)


def test_cross_attention_decode_matches_jax_sdpa():
    """One token against cached cross K/V: every key visible, no rope."""
    from repro_torch.models import layers as TL
    cfg, jcfg, tp, jp = layer_pair(False, 2, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 1, 256)).astype(np.float32)
    ck = rng.standard_normal((3, 16, 2, 64)).astype(np.float32)
    cv = rng.standard_normal((3, 16, 2, 64)).astype(np.float32)
    got = TL.cross_attention_decode(tp, torch.from_numpy(x),
                                    torch.from_numpy(ck),
                                    torch.from_numpy(cv), cfg)
    q = (jnp.asarray(x) @ jp["wq"]).reshape(3, 1, 4, 64)
    want = JL._sdpa(q, jnp.asarray(ck), jnp.asarray(cv),
                    jnp.ones((3, 1, 16), bool), 1.0 / 8.0)
    close(got, want.reshape(3, 1, -1) @ jp["wo"])


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------

def test_encode_matches_jax():
    model, jmodel, jparams = pair()
    tb, jb = batches(model.cfg, jmodel.cfg, 2, 8)
    got = ED.encode(model.params, model.cfg, tb["frames"])
    want = JED.encode(jparams, jmodel.cfg, jb["frames"])
    assert got.shape == (2, 16, 256)
    close(got, want)


def test_forward_matches_jax():
    model, jmodel, jparams = pair()
    tb, jb = batches(model.cfg, jmodel.cfg, 2, 12, seed=2)
    logits, aux = model.apply(tb)
    jlogits, jaux = jmodel.apply(jparams, jb)
    assert logits.shape == (2, 12, model.cfg.vocab_size)
    assert float(aux) == float(jaux) == 0.0
    close(logits, jlogits)


def test_prefill_and_teacher_forced_decode_match_jax():
    model, jmodel, jparams = pair()
    tb, jb = batches(model.cfg, jmodel.cfg, 2, 11, seed=3)
    logits, cache = model.prefill(tb, 20)
    jlogits, jcache = jmodel.prefill(jparams, jb, 20)
    assert logits.shape == (2, 1, model.cfg.vocab_size)
    assert cache["ck"].shape == (2, 2, 16, 4, 64)
    close(logits, jlogits)

    def same_cache(cache, jcache):
        for key in ("k", "v", "ck", "cv"):
            close(cache[key], jcache[key])
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
    model, jmodel, jparams = pair()
    tb, jb = batches(model.cfg, jmodel.cfg, 3, 10, seed=4)
    got = serve.generate(model, {k: tb[k] for k in ("tokens", "frames")},
                         new_tokens=6)
    logits, cache = jmodel.prefill(jparams, jb, 16)
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
    logits, _ = model.prefill(tb, 12)
    jlogits, _ = jmodel.prefill(jparams, jb, 12)
    want = np.asarray(jlogits, np.float32)
    err = np.abs(logits.float().numpy() - want).max()
    assert err <= 0.05 * np.abs(want).max()


def test_converter_round_trips_the_whole_tree():
    """Both packages' whisper trees cross ``convert`` leaf for leaf, bf16
    bit for bit."""
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
    jcfg, cfg = configs(num_encoder_layers=4)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tb, jb = batches(cfg, jcfg, 2, 12, seed=6)

    def jloss(p):
        if order is not None:
            p = _permute_tower(p, "enc_blocks", jnp.asarray(order))
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
    """``swapped``: CheckFree+'s order of 4 one-layer encoder stages against
    JAX's permuted ``enc_blocks``."""
    order = swap_permutation(4, 4).tolist() if swapped else None
    (jl, jm, jg), (loss, metrics, params) = loss_and_grads_pair(order)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    jleaves = {tuple(k.key for k in path): np.asarray(v) for path, v in
               jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(TR.leaves_with_path(params))
    assert set(got) == set(jleaves)
    assert ("dec_blocks", "cross_attn", "wk") in got
    for path, leaf in got.items():
        assert leaf.grad is not None, path
        close_rel(leaf.grad.numpy(), jleaves[path], GRAD_REL, "/".join(path))


def test_encdec_stages_its_encoder_tower_as_jax():
    """The JAX trainer stages ``towers(cfg)[0]``, the encoder (its class
    docstring names the decoder; the code is what the port follows)."""
    jcfg, cfg = configs(num_encoder_layers=4)
    part, jpart = StagePartition(cfg, 2), JPart(jcfg, 2)
    assert part.tower_key == jpart.tower_key == "enc_blocks"
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    assert part.stage0_keys(params) == jpart.stage0_keys(jparams)
    assert "dec_blocks" not in part.stage0_keys(params)
    assert part.get_stage(params, 1)["attn"]["wq"].shape == (2, 256, 256)
    flags = part.tower_flags(params)
    paths = [path for path, _ in TR.leaves_with_path(params)]
    assert [p[0] == "enc_blocks" for p in paths] == flags and any(flags)


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
    _, cfg = configs(num_encoder_layers=4)
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
    jcfg, cfg = configs(num_encoder_layers=4)
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
    assert trainer.part.tower_key == jtrainer.part.tower_key == "enc_blocks"
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
    jcfg, cfg = configs(num_encoder_layers=4)
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
    on the CPU; the encoder's two layers are the staged tower."""
    hist = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--strategy", "checkfree_plus", "--steps", "4",
                       "--seq", "16", "--batch", "2", "--rate", "0",
                       "--quiet"])
    assert len(hist.loss) == 4 and np.isfinite(hist.loss).all()
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--new-tokens", "3"])
    assert res.tokens.shape == (2, 3)
