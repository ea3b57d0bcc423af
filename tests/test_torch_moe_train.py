"""Training the MoE family in the port, against the JAX package, on the CPU.

Model level: ``Model.loss`` (ce + router_aux_coef * aux), ce, aux and every
gradient leaf of small granite-moe and deepseek-moe models (4 layers,
d_model 64, 4 heads of 16 (granite GQA 4/2), E 4, top-2, d_ff_expert 32;
deepseek with one shared expert), with JAX parameters carried over by the
converter, against JAX's ``Model.loss`` in fp32: the loss, ce and aux at
1e-5 relative, each gradient leaf within 1e-4 of its largest |g|; also with
the tower walked in CheckFree+'s swapped order against JAX's permuted tower.

Slice level: the port's ``Trainer`` with ``checkfree`` and
``checkfree_plus`` on both models against the JAX trainer at
``fuse_window`` 1 and 8 under a forced schedule that fails an intermediate
stage, two at once and the last (edge) stage: equal failures and traces,
losses at 1e-4 relative, recovery errors at 1e-3 relative
(tests/test_torch_trainer.py says why), and the aux trace, step by step, at
1e-4 relative.  The port's windows 1 and 8 give the same bits (losses, aux,
parameters).  The launchers on the CPU: train, serve and the MoE staging;
CheckFree+'s halves sharing one cast of the masters (``twin_cast``) with
the bits of two casts; and the profiler's ``index`` family, where the MoE
routing and dispatch kernels are counted.
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
from repro.models.model import build_model as jax_build_model
from repro_torch import config as C
from repro_torch import configs as CS
from repro_torch import tree as TR
from repro_torch.convert import params_from_numpy
from repro_torch.core.stages import StagePartition
from repro_torch.core.swap import swap_permutation
from repro_torch.core.trainer import Trainer
from repro_torch.core.window import RECORD
from repro_torch.data.pipeline import SyntheticLM, batch_for, make_batches
from repro_torch.launch import serve, train
from repro_torch.models.model import Model

ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
LOSS_RTOL, RECOVERY_RTOL, AUX_RTOL = 1e-4, 1e-3, 1e-4
GRAD_REL = 1e-4          # each model gradient leaf, of its largest |g|
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


def small(arch, pkg):
    """A small granite-moe or deepseek-moe of ``pkg`` (the JAX or the port's
    config module), fp32."""
    cfg_mod, configs = pkg
    cfg = configs.get_config(arch)
    moe = cfg_mod.MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                            num_shared_experts=min(
                                cfg.moe.num_shared_experts, 1))
    return cfg.replace(name=f"{arch}-small", num_layers=4, d_model=64,
                       num_heads=4, num_kv_heads=2 if arch.startswith(
                           "granite") else 4, head_dim=16, vocab_size=128,
                       max_seq_len=64, dtype="float32", moe=moe)


JAX_PKG, PORT_PKG = (JC, JCS), (C, CS)


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
            p = _permute_tower(p, "blocks", jnp.asarray(order))
        return jmodel.loss(p, jbatch)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = TR.map(lambda t: t.requires_grad_(), params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    model = Model(cfg, device="cpu", weights=False)
    loss, metrics = model.loss(params, tbatch, order=order)
    loss.backward()
    return (float(jl), jm, jg), (loss, metrics, params)


def close_rel(got, want, rel, name=""):
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("swapped", [False, True])
def test_model_loss_and_gradients_match_jax(arch, swapped):
    """``swapped``: CheckFree+'s swapped order of 4 one-layer stages
    (``core.swap.swap_permutation``) against JAX's permuted tower."""
    order = None
    if swapped:
        order = swap_permutation(4, 4).tolist()
        assert order == jax_swap_permutation(4, 4).tolist() != [0, 1, 2, 3]
    (jl, jm, jg), (loss, metrics, params) = loss_and_grads_pair(arch, order)
    aux = float(metrics["aux"].detach())
    assert aux > 1.0                    # four layers of about 1 each
    np.testing.assert_allclose(aux, float(jm["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    coef = small(arch, PORT_PKG).moe.router_aux_coef
    np.testing.assert_allclose(
        float(loss.detach()), float(metrics["ce"].detach()) + coef * aux,
        rtol=1e-6)
    jleaves = {tuple(k.key for k in path): np.asarray(v) for path, v in
               jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(TR.leaves_with_path(params))
    assert set(got) == set(jleaves)
    assert ("blocks", "mlp", "router") in got
    for path, leaf in got.items():
        assert leaf.grad is not None, path
        close_rel(leaf.grad.numpy(), jleaves[path], GRAD_REL, "/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_stages_its_blocks_tower_as_jax(arch):
    jcfg, cfg = small(arch, JAX_PKG), small(arch, PORT_PKG)
    part, jpart = StagePartition(cfg, 2), JPart(jcfg, 2)
    assert part.tower_key == jpart.tower_key == "blocks"
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    assert part.stage0_keys(params) == jpart.stage0_keys(jparams)
    stage = part.get_stage(params, 1)
    assert stage["mlp"]["w_gate"].shape == (2, 4, 64, 32)
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
    jsrc, src = JSource(128, seed=1234), SyntheticLM(128, seed=1234)
    jrng, rng = np.random.default_rng(7), np.random.default_rng(7)
    return ([jax_batch_for(jcfg, jsrc.sample(jrng, BATCH, SEQ))],
            [batch_for(cfg, src.sample(rng, BATCH, SEQ))])


def recording_aux(trainer: Trainer, window: int) -> list:
    """The aux of every step the port's trainer runs, in order: from the
    eager step's metrics (window 1) or each window's ring."""
    trace = []
    if window == 1:
        step = trainer.step

        def recorded(state, batch):
            state, loss, metrics = step(state, batch)
            trace.append(float(metrics["aux"]))
            return state, loss, metrics

        trainer.step = recorded
    else:
        runner = trainer.window
        drain = runner.drain

        def drained(pending):
            state, ring = drain(pending)
            trace.extend(ring[:, RECORD.index("aux")].tolist())
            return state, ring

        runner.drain = drained
    return trace


def jax_recording_aux(jtrainer) -> list:
    trace = []
    fused = jtrainer.fused_step

    def recorded(*args):
        out = fused(*args)
        trace.extend(np.asarray(out[3]["aux"]).tolist())
        return out

    jtrainer.fused_step = recorded
    return trace


def port_run(arch, strategy, window, tmp, params, evals):
    cfg = small(arch, PORT_PKG)
    trainer = Trainer(Model(cfg, device="cpu", weights=False),
                      train_configs(C, strategy, window, tmp,
                                    f"torch{window}"),
                      schedule=Forced(EVENTS))
    aux = recording_aux(trainer, window)
    state, hist = trainer.run(make_batches(cfg, batch=BATCH, seq=SEQ, seed=0),
                              evals, params=TR.clone(params))
    return trainer, state, hist, aux


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
    jaux = jax_recording_aux(jtrainer)
    _, jhist = jtrainer.run(jax_make_batches(jcfg, batch=BATCH, seq=SEQ,
                                             seed=0), eval_batches=jevals)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        device="cpu")
    trainer, state, hist, aux = port_run(arch, strategy, window, tmp_path,
                                         params, evals)
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
    assert len(aux) == len(jaux) == STEPS
    assert all(1.0 < a < 10.0 for a in aux)
    np.testing.assert_allclose(aux, jaux, rtol=AUX_RTOL)
    assert [s for s, _, _ in hist.eval_loss] == \
        [s for s, _, _ in jhist.eval_loss] != []
    np.testing.assert_allclose([e for _, _, e in hist.eval_loss],
                               [e for _, _, e in jhist.eval_loss],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("strategy", ["checkfree", "checkfree_plus"])
def test_windows_1_and_8_give_the_same_bits(arch, strategy, tmp_path):
    cfg = small(arch, PORT_PKG)
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(3))
    _, evals = eval_sets(small(arch, JAX_PKG), cfg)
    runs = [port_run(arch, strategy, w, tmp_path, params, evals)
            for w in (1, 8)]
    (_, s1, h1, a1), (_, s8, h8, a8) = runs
    assert h1.dispatches > h8.dispatches
    assert h1.loss == h8.loss and a1 == a8 and h1.failures == h8.failures
    assert h1.recovery_errors == h8.recovery_errors
    for x, y in zip(TR.leaves(s1.params), TR.leaves(s8.params)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_train_and_serve_on_the_cpu(arch):
    """``launch.train`` with CheckFree+ (an eval after each step) and
    ``launch.serve``, both ``--reduced --device cpu``."""
    hist = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--strategy", "checkfree_plus", "--steps", "4",
                       "--seq", "32", "--batch", "2", "--rate", "0",
                       "--quiet"])
    assert len(hist.loss) == 4 and np.isfinite(hist.loss).all()
    assert hist.wall_iters == 4 and len(hist.eval_loss) == 4
    res = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--new-tokens", "3"])
    assert res.tokens.shape == (2, 3)


def test_twin_cast_gives_the_bits_of_two_casts():
    """CheckFree+'s two halves share one bf16 copy of the masters
    (``core.trainer.twin_cast``); the values, and the fp32 gradients summed
    from both halves, are those of casting once per half."""
    from repro_torch.core.trainer import twin_cast
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(8, 6, generator=gen),
            "n": {"scale": torch.randn(6, generator=gen),
                  "ids": torch.arange(3)}}
    x = torch.randn(5, 8, generator=gen).bfloat16()

    def loss(t1, t2):
        y1 = (x @ t1["w"]) * t1["n"]["scale"]
        y2 = (x @ t2["w"]).square() * t2["n"]["scale"]
        return y1.float().sum() + y2.float().sum()

    grads = []
    for shared in (True, False):
        leaves = TR.map(lambda t: t.clone().requires_grad_()
                        if t.is_floating_point() else t, tree)
        if shared:
            t1, t2 = twin_cast(leaves, torch.bfloat16)
            assert t1["w"].data_ptr() == t2["w"].data_ptr()
            assert t1["n"]["ids"] is leaves["n"]["ids"]
        else:
            t1 = {"w": leaves["w"].bfloat16(),
                  "n": {"scale": leaves["n"]["scale"].bfloat16(),
                        "ids": leaves["n"]["ids"]}}
            t2 = {"w": leaves["w"].bfloat16(),
                  "n": {"scale": leaves["n"]["scale"].bfloat16(),
                        "ids": leaves["n"]["ids"]}}
        out = loss(t1, t2)
        out.backward()
        grads.append((out, leaves["w"].grad, leaves["n"]["scale"].grad))
    for a, b in zip(*grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_profile_counts_the_moe_routing_kernels_as_index():
    """``launch.profile``'s families: PyTorch's gathers, scatters, sorts and
    scans (where the MoE routing and dispatch run) in ``index``, apart from
    the port's kernels and the element-wise passes."""
    from repro_torch.launch import profile as PR
    for name in (
            "void at::native::(anonymous namespace)::indexSelectLargeIndex"
            "<c10::BFloat16, long, unsigned int, 2, 2, -2, true>",
            "void at::native::_scatter_gather_elementwise_kernel<128, 8>",
            "void at::native::tensor_kernel_scan_innermost_dim<long>",
            "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel",
            "void at::native::sortKeyValueInplace<float, long>"):
        assert PR._family(name) == "index", name
    assert PR._family("void (anonymous namespace)::flash_fwd_bf16_kernel"
                      "<64>((anonymous namespace)::Params)") == \
        "flash_attention"
    assert PR._family("(anonymous namespace)::ssd_scan_bf16_kernel<128>"
                      "((anonymous namespace)::Params)") == "ssd_scan"
    assert PR._family("void at::native::vectorized_elementwise_kernel<4>"
                      "(int)") == "other"
