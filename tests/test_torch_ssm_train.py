"""Training the SSM and hybrid families in the port, against the JAX package.

Kernel level: the plain SSD backward (``ref.ssd_chunked_bwd_ref``, the
function of ``csrc/ssd_scan_bwd.cu``) against PyTorch's float64 autograd of
``ref.ssd_chunked`` at 1e-10, with and without a starting state and a
gradient of the final state, on ragged and grouped shapes; the port's fp32
gradients (autograd of ``ssd_chunked`` and the plain backward) against
``jax.grad`` of ``repro.models.ssm.ssd_chunked`` at 1e-5 of each gradient's
largest magnitude, where JAX's gradient is finite.  At the real decay range
(a = -1.6 a token, chunk 64) JAX's gradient is NaN (its ``jnp.exp`` runs over
the full Q x Q exponent before ``jnp.where`` masks it; ROADMAP.md queue 3):
the port's is finite and equals its own float64 autograd.

Model level: ``Model.loss`` and every gradient leaf of small mamba2 and
zamba2 models (4 layers, d_model 64, P 16, N 16, chunk 8; zamba2 with the
shared block after every 2 layers), with JAX parameters carried over by the
converter, against JAX's ``Model.loss``: the loss at 1e-5 relative, each
leaf within 1e-4 of its largest |g|, in fp32; also with the tower walked in
CheckFree+'s swapped order against JAX's permuted tower.

Slice level: the port's ``Trainer`` with ``checkfree`` and
``checkfree_plus`` on both families against the JAX trainer at
``fuse_window`` 1 and 8 under a forced schedule (a merge, a consecutive run
of two, an edge stage) with eval points: equal failures and traces, losses
and eval losses at 1e-4 relative, recovery errors at 1e-3 relative
(tests/test_torch_trainer.py says why); and the launcher on the CPU for
mamba2-1.3b and zamba2-2.7b with ``--reduced``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro import configs as JCS
from repro.core.stages import StagePartition as JPart
from repro.core.swap import swap_permutation as jax_swap_permutation
from repro.core.trainer import Trainer as JTrainer
from repro.core.trainer import _permute_tower
from repro.data.pipeline import SyntheticLM as JSource
from repro.data.pipeline import batch_for as jax_batch_for
from repro.data.pipeline import make_batches as jax_make_batches
from repro.models import ssm as JS
from repro.models.model import build_model as jax_build_model
from repro_torch import config as C
from repro_torch import configs as CS
from repro_torch import tree as TR
from repro_torch.convert import params_from_numpy
from repro_torch.core.stages import StagePartition
from repro_torch.core.swap import swap_permutation
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import SyntheticLM, batch_for, make_batches
from repro_torch.kernels import ref
from repro_torch.launch import train
from repro_torch.models.model import Model

ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]
LOSS_RTOL, RECOVERY_RTOL = 1e-4, 1e-3
GRAD_REL = 1e-4          # each model gradient leaf, of its largest |g|
SSD_GRAD_REL = 1e-5      # the SSD scan's gradients against JAX, fp32
STAGES, BATCH, SEQ, STEPS = 4, 4, 32, 12
EVENTS = {2: [1], 5: [1, 2], 9: [3]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the SSD scan's backward
# ---------------------------------------------------------------------------

def ssd_arrays(seed, b, t, h, p, g, n, *, decay=None):
    """Model layout, numpy: xb (B, T, H, P), a (B, T, H) (-0.1 |N(0, 1)|, or
    the constant ``decay`` a token), B and C (B, T, G, N), a starting state
    (B, H, P, N), dy and dfinal."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((b, t, h, p))
    a = (np.full((b, t, h), decay) if decay is not None
         else -0.1 * np.abs(rng.standard_normal((b, t, h))))
    bm = 0.4 * rng.standard_normal((b, t, g, n))
    cm = 0.4 * rng.standard_normal((b, t, g, n))
    s0 = 0.5 * rng.standard_normal((b, h, p, n))
    dy = rng.standard_normal((b, t, h, p))
    df = rng.standard_normal((b, h, p, n))
    return x, a, bm, cm, s0, dy, df


def autograd_of_plain(arrs, chunk, dtype, init, dfinal):
    """PyTorch's autograd of ``ref.ssd_chunked`` in ``dtype``: (dxb, da,
    dbmat, dcmat, dinit or None)."""
    x, a, bm, cm, s0, dy, df = (torch.tensor(v, dtype=dtype) for v in arrs)
    ins = [t.requires_grad_() for t in (x, a, bm, cm)]
    if init:
        ins.append(s0.requires_grad_())
    y, final = ref.ssd_chunked(*ins[:4], chunk, s0 if init else None)
    loss = (y * dy).sum() + ((final * df).sum() if dfinal else 0.0)
    grads = torch.autograd.grad(loss, ins)
    return (*grads[:4], grads[4] if init else None)


def plain_bwd(arrs, chunk, dtype, init, dfinal):
    x, a, bm, cm, s0, dy, df = (torch.tensor(v, dtype=dtype) for v in arrs)
    out = ref.ssd_chunked_bwd_ref(x, a, bm, cm, chunk, s0 if init else None,
                                  dy, df if dfinal else None)
    return (*out[:4], out[4] if init else None)


def jax_grads(arrs, chunk, init, dfinal):
    x, a, bm, cm, s0, dy, df = (jnp.asarray(v, jnp.float32) for v in arrs)

    def loss(x, a, bm, cm, s0):
        y, final = JS.ssd_chunked(x, a, bm, cm, chunk, s0 if init else None)
        return (y * dy).sum() + ((final * df).sum() if dfinal else 0.0)

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(x, a, bm, cm, s0)


@pytest.mark.parametrize("b,t,h,p,g,n,chunk", [
    (2, 32, 4, 8, 2, 4, 8),      # grouped, even
    (2, 37, 4, 8, 1, 16, 16),    # ragged last chunk
    (1, 23, 2, 16, 1, 16, 7),    # ragged, an odd chunk
    (2, 9, 2, 4, 2, 4, 1),       # chunk of 1
])
@pytest.mark.parametrize("init,dfinal", [(False, False), (True, True),
                                         (True, False), (False, True)])
def test_plain_backward_matches_float64_autograd(b, t, h, p, g, n, chunk,
                                                 init, dfinal):
    arrs = ssd_arrays(1, b, t, h, p, g, n)
    got = plain_bwd(arrs, chunk, torch.float64, init, dfinal)
    want = autograd_of_plain(arrs, chunk, torch.float64, init, dfinal)
    for name, gg, w in zip(("dx", "da", "db", "dc", "dinit"), got, want):
        if w is None:
            continue
        assert gg.dtype == torch.float64, name
        np.testing.assert_allclose(gg.numpy(), w.numpy(), atol=1e-10,
                                   rtol=1e-10, err_msg=name)


def close_rel(got, want, rel, name=""):
    """|got - want| <= rel * max |want| everywhere, both finite."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{name}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("b,t,h,p,g,n,chunk", [
    (2, 64, 4, 16, 2, 16, 16), (1, 64, 2, 16, 1, 16, 64),
    (2, 32, 4, 16, 1, 16, 8)])
@pytest.mark.parametrize("init,dfinal", [(False, False), (True, True)])
def test_plain_gradients_match_jax_where_jax_is_finite(b, t, h, p, g, n,
                                                       chunk, init, dfinal):
    """The decay of tests/test_kernels.py's draws: JAX's gradient is finite,
    and the port's (autograd of ``ssd_chunked``, the CPU training path, and
    the plain backward) equal it in fp32."""
    arrs = ssd_arrays(2, b, t, h, p, g, n)
    want = jax_grads(arrs, chunk, init, dfinal)
    for got in (autograd_of_plain(arrs, chunk, torch.float32, init, dfinal),
                plain_bwd(arrs, chunk, torch.float32, init, dfinal)):
        for name, gg, w in zip(("dx", "da", "db", "dc", "dinit"), got, want):
            if gg is not None:
                close_rel(gg.numpy(), w, SSD_GRAD_REL, name)


def test_jax_gradient_is_nan_at_the_real_decay_range_and_the_port_is_not():
    """a = -1.6 a token (mamba's init reaches it: dt up to 0.1, A down to
    -16), chunk 64: a chunk's log decay spans ~-100, so JAX's
    exp(cs_i - cs_j) above the diagonal overflows in fp32 before
    ``jnp.where`` masks it, and the masked branch's gradient is 0 * inf.
    The port exponentiates only where j <= i: its fp32 gradients are finite
    and equal its float64 autograd.  A reference divergence (ROADMAP.md
    queue 3), not a port fault."""
    arrs = ssd_arrays(3, 1, 128, 4, 8, 1, 16, decay=-1.6)
    jx, ja, jb, jc, _ = jax_grads(arrs, 64, False, False)
    assert np.isnan(np.asarray(ja)).any()
    assert np.isnan(np.asarray(jb)).any() and np.isnan(np.asarray(jc)).any()
    want = autograd_of_plain(arrs, 64, torch.float64, False, False)
    for got in (autograd_of_plain(arrs, 64, torch.float32, False, False),
                plain_bwd(arrs, 64, torch.float32, False, False)):
        for name, gg, w in zip(("dx", "da", "db", "dc"), got, want):
            close_rel(gg.numpy(), w.numpy(), SSD_GRAD_REL, name)


# ---------------------------------------------------------------------------
# Model.loss and its gradients against JAX
# ---------------------------------------------------------------------------

def small(arch, pkg):
    """A small mamba2 or zamba2 of ``pkg`` (the JAX or the port's config
    module): 4 layers, d_model 64, P 16, N 16, chunk 8, fp32; zamba2 with 4
    heads of 16 and the shared block after every 2 layers."""
    cfg_mod, configs = pkg
    kw = dict(num_layers=4, d_model=64, vocab_size=128, max_seq_len=64,
              dtype="float32",
              ssm=cfg_mod.SSMConfig(state_dim=16, head_dim=16, expand=2,
                                    conv_width=4, chunk_size=8, ngroups=1))
    if arch == "zamba2-2.7b":
        kw.update(num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                  attn_every=2)
    return configs.get_config(arch).replace(name=f"{arch}-small", **kw)


JAX_PKG, PORT_PKG = (JC, JCS), (C, CS)


def tower_key(arch):
    return "mamba" if arch == "zamba2-2.7b" else "blocks"


def loss_and_grads_pair(arch, order):
    jcfg, cfg = small(arch, JAX_PKG), small(arch, PORT_PKG)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    raw = SyntheticLM(cfg.vocab_size, seed=5).sample(
        np.random.default_rng(6), BATCH, SEQ)
    jbatch = {k: jnp.asarray(v) for k, v in jax_batch_for(jcfg, raw).items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch_for(cfg, raw).items()}

    def jloss(p):
        if order is not None:
            p = _permute_tower(p, tower_key(arch), jnp.asarray(order))
        return jmodel.loss(p, jbatch)[0]

    jl, jg = jax.value_and_grad(jloss)(jparams)
    params = TR.map(lambda t: t.requires_grad_(), params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    model = Model(cfg, device="cpu", weights=False)
    loss, metrics = model.loss(params, tbatch, order=order)
    loss.backward()
    return (float(jl), jg), (loss, metrics, params)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("swapped", [False, True])
def test_model_loss_and_gradients_match_jax(arch, swapped):
    """``swapped``: CheckFree+'s swapped order of 4 one-layer stages
    (``core.swap.swap_permutation``) against JAX's permuted tower."""
    order = None
    if swapped:
        order = swap_permutation(4, 4).tolist()
        assert order == jax_swap_permutation(4, 4).tolist() != [0, 1, 2, 3]
    (jl, jg), (loss, metrics, params) = loss_and_grads_pair(arch, order)
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), jl, rtol=1e-5)
    jleaves = {tuple(k.key for k in path): np.asarray(v) for path, v in
               jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(TR.leaves_with_path(params))
    assert set(got) == set(jleaves)
    for path, leaf in got.items():
        assert leaf.grad is not None, path
        close_rel(leaf.grad.numpy(), jleaves[path], GRAD_REL, "/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_families_stage_their_towers_as_jax(arch):
    """The staged tower (``blocks`` for mamba2, ``mamba`` for zamba2) with
    the embedding, head norm and zamba2's shared block as stage-0 extras;
    the tower leaves flagged for ``adam_sumsq``'s per-layer sums."""
    jcfg, cfg = small(arch, JAX_PKG), small(arch, PORT_PKG)
    part, jpart = StagePartition(cfg, 2), JPart(jcfg, 2)
    assert part.tower_key == jpart.tower_key == tower_key(arch)
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    assert part.stage0_keys(params) == jpart.stage0_keys(jparams)
    if arch == "zamba2-2.7b":
        assert "shared_attn" in part.stage0_keys(params)
    flags = part.tower_flags(params)
    paths = [path for path, _ in TR.leaves_with_path(params)]
    assert [p[0] == tower_key(arch) for p in paths] == flags and any(flags)


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
    jsrc, src = JSource(128, seed=1234), SyntheticLM(128, seed=1234)
    jrng, rng = np.random.default_rng(7), np.random.default_rng(7)
    return ([jax_batch_for(jcfg, jsrc.sample(jrng, BATCH, SEQ))],
            [batch_for(cfg, src.sample(rng, BATCH, SEQ))])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("strategy", ["checkfree", "checkfree_plus"])
@pytest.mark.parametrize("window", [1, 8])
def test_trainer_matches_jax(arch, strategy, window, tmp_path):
    jcfg, cfg = small(arch, JAX_PKG), small(arch, PORT_PKG)
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
    trainer = Trainer(Model(cfg, device="cpu", weights=False),
                      train_configs(C, strategy, window, tmp_path, "torch"),
                      schedule=Forced(EVENTS))
    state, hist = trainer.run(make_batches(cfg, batch=BATCH, seq=SEQ, seed=0),
                              evals, params=params)
    assert state.effective_step == STEPS
    assert [tuple(f) for f in hist.failures] == \
        [tuple(f) for f in jhist.failures] == [(2, 1), (5, 1), (5, 2), (9, 3)]
    assert hist.steps == jhist.steps
    assert hist.wall_iters == jhist.wall_iters
    assert hist.dispatches == jhist.dispatches
    assert trainer.dispatched_buckets == jtrainer.dispatched_buckets
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


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_the_cpu(arch):
    """``python -m repro_torch.launch.train --arch <arch> --reduced --device
    cpu``: both families train with CheckFree+ and evaluate through their
    own forward (4 steps: an eval after each, so one step a window)."""
    hist = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--strategy", "checkfree_plus", "--steps", "4",
                       "--seq", "32", "--batch", "2", "--rate", "0",
                       "--quiet"])
    assert len(hist.loss) == 4 and np.isfinite(hist.loss).all()
    assert hist.wall_iters == 4 and len(hist.eval_loss) == 4
    assert np.isfinite([e for _, _, e in hist.eval_loss]).all()
