"""The port's pipeline-parallel backend on 4 gloo ranks of the CPU, against
the JAX package (the checks of tests/pipeline_spmd_check.py, §1-§5).

The port's ranks are spawned (``launch.mesh.spawn_stages``) and import no
JAX: this module imports JAX only inside its fixtures and tests, which run
in the pytest process, and each rank reports whether JAX reached its
``sys.modules``.  The ranks get numpy inputs and leave their results in
``tmp_path``.  One spawn covers the file; the trainer runs, (e) and (g),
are tests/test_torch_pipeline_spmd_train.py's.

* (a) ``pipeline_loss`` of the 8-layer d 32 model (K 4, M 2, batch 8 x 16)
  against JAX's ``model.loss``, rtol 2e-5;
* (b) its gradients against ``jax.grad``, atol 1e-5, rtol 1e-4;
* (c) the in-mesh recovery against the port's host ``recover_stage``: bit
  for bit for a middle-stage merge (Alg. 1 and uniform), both edges and
  ``copy_prev``, the replicated leaves untouched;
* (d) one CheckFree+ step (the swapped route on half the batch) under a
  loss mask whose density varies by microbatch, against the port's host
  step and JAX's host fused step: rings rtol 2e-4 / atol 1e-6, omegas rtol
  2e-3, parameters atol 1e-5.  JAX's own check holds its SPMD step to 2e-6,
  which that step misses by 4.6e-6 under this JAX (ROADMAP.md queue 3);
  1e-5 is the one tolerance looser than that check's;
* (e) ``Trainer(backend="spmd")`` runs of ``checkfree`` {3: [2]},
  ``checkfree_plus`` {2: [0], 4: [2]} and ``checkfree`` {3: [1, 2]} (a
  consecutive run: the gathered path) at windows 1 and 4 against the JAX
  host trainer at window 1 and the port's host trainer: the same failures,
  losses and eval losses at 1e-4 relative, recovery errors at 1e-3
  (tests/test_torch_trainer.py says why);
* (f) a small granite-moe (4 layers) at M 1 against JAX's ``model.loss``
  and gradients, and at M 2 against the CE of the whole batch plus the mean
  of JAX's per-microbatch aux (``repro/pipeline/spmd.py:148-160``);
* (g) rank 0's telemetry stream of the window-1 runs against the JAX host
  run's, as tests/test_torch_telemetry.py compares them (``backend``
  aside), with one ``spmd_window_dispatch`` span a dispatch.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch import config as C
from repro_torch import configs as CS
from repro_torch import tree as TR
from repro_torch.config import (ModelConfig, OptimizerConfig, RecoveryConfig,
                                TrainConfig)
from repro_torch.convert import params_from_numpy
from repro_torch.core.recovery import recover_stage
from repro_torch.core.stages import StagePartition
from repro_torch.core.trainer import Trainer
from repro_torch.core.window import OMEGAS, RECORD
from repro_torch.launch.mesh import make_stage_group, spawn_stages
from repro_torch.models.model import Model
from repro_torch.optim.adam import init_adam
from repro_torch.pipeline import spmd
from repro_torch.pipeline.transport import Transport

K, M = 4, 2
CFG = dict(name="pp-llama", arch_type="dense", num_layers=8, d_model=32,
           num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
           max_seq_len=32, dtype="float32", param_dtype="float32")
OMEGA_VALUES = [1.0, 3.0, 0.5, 2.0]
RECOVERIES = [(2, "grad_norm"), (1, "uniform"), (0, "grad_norm"),
              (K - 1, "grad_norm"), (0, "copy_prev"), (1, "copy_prev"),
              (K - 1, "copy_prev"), (2, "twin_copy")]
OCFG = dict(lr=1e-3, total_steps=10, warmup_steps=2)
# (e): the runs, and the training config of the JAX check's section 5
RUNS = {"checkfree": {3: [2]}, "checkfree_plus": {2: [0], 4: [2]},
        "checkfree-consecutive": {3: [1, 2]}}
WINDOWS = (1, 4)
STEPS, BATCH, SEQ = 6, 8, 32
LOSS_RTOL, RECOVERY_RTOL = 1e-4, 1e-3
RANK_TIMEOUT_S = 300.0


def moe_config(pkg_config, pkg_configs):
    """tests/test_torch_moe_train.py's small granite-moe, fp32."""
    cfg = pkg_configs.get_config("granite-moe-3b-a800m")
    moe = pkg_config.MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                               num_shared_experts=0)
    return cfg.replace(name="granite-small", num_layers=4, d_model=64,
                       num_heads=4, num_kv_heads=2, head_dim=16,
                       vocab_size=128, max_seq_len=64, dtype="float32",
                       moe=moe)


def train_config(pkg_configs):
    return pkg_configs.reduced(pkg_configs.get_config(
        "paper-llama-124m")).replace(num_layers=8, max_seq_len=64,
                                     dtype="float32")


def trainer_config(O, R, T, name, window):
    strategy = name.split("-")[0]
    return T(global_batch=BATCH, microbatch=BATCH // M, seq_len=SEQ,
             steps=STEPS, eval_every=3, fuse_window=window,
             optimizer=O(lr=1e-3, total_steps=STEPS, warmup_steps=2),
             recovery=R(strategy=strategy, num_stages=K))


class Forced:
    def __init__(self, events):
        self.events = events

    def at(self, step):
        return list(self.events.get(step, []))


def _tensors(tree):
    return params_from_numpy(tree, device="cpu")


def _numpy(tree):
    return TR.map(lambda t: t.detach().numpy().copy(), tree)


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------

def _grads(shard):
    return TR.map(lambda t: (t.grad if t.grad is not None
                             else torch.zeros_like(t)).detach().clone(),
                  shard)


def _checks_rank(rank, inp):
    """(a)-(d) and (f) on one rank."""
    cfg = ModelConfig(**CFG)
    part = StagePartition(cfg, K)
    tr = Transport(make_stage_group(K), torch.device("cpu"))
    params = _tensors(inp["params"])
    batch = {k: torch.as_tensor(v) for k, v in inp["batch"].items()}
    out = {}
    # (a) the loss, (b) the gradients (replicated ones reduced)
    shard = TR.map(lambda t: t.clone().requires_grad_(),
                   spmd.shard_params(params, part, rank))
    out["loss"] = float(spmd.pipeline_loss(cfg, part, tr, M)(shard, batch))
    spmd.Pipeline(cfg, part, tr, M, use_swap=False).run(shard, batch,
                                                         grad=True)
    grads = _grads(shard)
    tr.all_reduce_([g for key, g in TR.leaves_with_path(grads)
                    if key[0] != "blocks"], "allreduce")
    out["grads"] = _numpy(grads)
    # (c) recovery by neighbour transfers
    rec = spmd.make_in_mesh_recover(tr, part)
    omegas = torch.tensor(OMEGA_VALUES)
    out["recovered"] = []
    for failed, reinit in RECOVERIES:
        shard = spmd.shard_params(params, part, rank)
        others = {k: v for k, v in shard.items() if k != "blocks"}
        got = rec(shard, omegas, failed, reinit)
        untouched = all(got[k] is v for k, v in others.items()) and all(
            torch.equal(a, b) for a, b in zip(
                TR.leaves(others), TR.leaves({k: params[k] for k in others})))
        out["recovered"].append((_numpy(got["blocks"]), untouched))
    # (d) one CheckFree+ step under the loss mask
    step = spmd.SpmdStep(cfg, part, tr, OptimizerConfig(**OCFG), M,
                         use_swap=True, lr_decay=1.0)
    shard = TR.map(lambda t: t.clone().requires_grad_(),
                   spmd.shard_params(params, part, rank))
    opt = init_adam(shard)
    masked = {k: torch.as_tensor(v) for k, v in inp["masked"].items()}
    record = step.body(shard, TR.leaves(opt.m), TR.leaves(opt.v), masked,
                       torch.zeros((), dtype=torch.int32),
                       torch.ones((), dtype=torch.float32))
    out["record"] = record.numpy()
    out["stepped"] = _numpy(shard)
    # (f) the small granite-moe at M 1 (loss, gradients) and M 2 (loss)
    mcfg = moe_config(C, CS)
    mpart = StagePartition(mcfg, K)
    mparams = _tensors(inp["moe_params"])
    mbatch = {k: torch.as_tensor(v) for k, v in inp["moe_batch"].items()}
    for mm in (1, 2):
        shard = TR.map(lambda t: t.clone().requires_grad_(),
                       spmd.shard_params(mparams, mpart, rank))
        out[f"moe_loss_m{mm}"] = float(
            spmd.pipeline_loss(mcfg, mpart, tr, mm)(shard, mbatch))
        if mm == 1:
            ce, aux = spmd.Pipeline(mcfg, mpart, tr, 1, use_swap=False).run(
                shard, mbatch, grad=True)
            grads = _grads(shard)
            tr.all_reduce_([g for key, g in TR.leaves_with_path(grads)
                            if key[0] != "blocks"], "allreduce")
            out["moe_grads"] = _numpy(grads)
    out["jax_imported"] = any(m.split(".")[0] in ("jax", "jaxlib", "repro")
                              for m in sys.modules)
    return out


# ---------------------------------------------------------------------------
# the JAX side and the spawns
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's parameters, batches, loss, gradients, fused step and the small
    MoE's, as numpy."""
    import jax
    import jax.numpy as jnp
    from repro import config as JC
    from repro import configs as JCS
    from repro.config import ModelConfig as JModelConfig
    from repro.config import OptimizerConfig as JOpt
    from repro.core.stages import StagePartition as JPart
    from repro.core.trainer import make_fused_train_step
    from repro.models.model import build_model
    from repro.optim.adam import init_adam as jinit_adam

    cfg = JModelConfig(**CFG)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    loss, grads = jax.value_and_grad(
        lambda p: model.loss(p, jbatch)[0])(params)
    mask = (rng.random((8, 16)) < np.linspace(0.9, 0.3, 8)[:, None]
            ).astype(np.float32)
    assert mask.reshape(4, 2, 16).sum((1, 2)).std() > 0
    masked = {"tokens": tokens, "labels": labels, "loss_mask": mask}
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params_np = to_np(params)
    fused = make_fused_train_step(model, JOpt(**OCFG), JPart(cfg, K),
                                  use_swap=True)
    fresh = jax.tree.map(jnp.asarray, params_np)   # the step donates it
    hp, _, _, hring = fused(fresh, jinit_adam(fresh),
                            {k: jnp.asarray(v)[None]
                             for k, v in masked.items()}, 1.0)
    mcfg = moe_config(JC, JCS)
    mmodel = build_model(mcfg)
    mparams = mmodel.init(jax.random.PRNGKey(1))
    mtokens = rng.integers(0, mcfg.vocab_size, (4, 32)).astype(np.int32)
    mlabels = rng.integers(0, mcfg.vocab_size, (4, 32)).astype(np.int32)
    mbatch = {"tokens": jnp.asarray(mtokens), "labels": jnp.asarray(mlabels)}
    (mloss, mmetrics), mgrads = jax.value_and_grad(
        lambda p: mmodel.loss(p, mbatch), has_aux=True)(mparams)
    aux_mb = [float(mmodel.loss(mparams, {k: v[2 * i:2 * i + 2] for k, v in
                                          mbatch.items()})[1]["aux"])
              for i in range(2)]
    return {
        "params": params_np, "batch": {"tokens": tokens,
                                           "labels": labels},
        "loss": float(loss), "grads": to_np(grads), "masked": masked,
        "step_params": to_np(hp),
        "ring": {k: np.asarray(v) for k, v in hring.items()},
        "moe_params": to_np(mparams),
        "moe_batch": {"tokens": mtokens, "labels": mlabels},
        "moe_loss": float(mloss), "moe_ce": float(mmetrics["ce"]),
        "moe_grads": to_np(mgrads), "moe_aux_mb": aux_mb,
        "moe_coef": mcfg.moe.router_aux_coef}


@pytest.fixture(scope="module")
def checks(jax_side, tmp_path_factory):
    inp = {k: jax_side[k] for k in ("params", "batch", "masked",
                                    "moe_params", "moe_batch")}
    return spawn_stages(_checks_rank, K, inp, timeout_s=RANK_TIMEOUT_S,
                        workdir=str(tmp_path_factory.mktemp("checks")))


def whole(shards, part=None):
    """The ranks' shards as one tree: the towers concatenated, the
    replicated leaves rank 0's (the same on every rank, checked)."""
    out = {}
    for key in shards[0]:
        if key == "blocks":
            out[key] = TR.map(lambda *xs: np.concatenate(xs),
                              *[s[key] for s in shards])
        else:
            for s in shards[1:]:
                for a, b in zip(TR.leaves(shards[0][key]), TR.leaves(s[key])):
                    np.testing.assert_array_equal(a, b, err_msg=key)
            out[key] = shards[0][key]
    return out


def leaves_by_path(tree):
    return {path: np.asarray(v) for path, v in TR.leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# (a)-(d), (f)
# ---------------------------------------------------------------------------

def test_ranks_import_no_jax(checks):
    assert not any(r["jax_imported"] for r in checks)


def test_pipeline_loss_matches_jax(checks, jax_side):
    for r in checks:
        np.testing.assert_allclose(r["loss"], jax_side["loss"], rtol=2e-5)


def test_pipeline_gradients_match_jax(checks, jax_side):
    got = leaves_by_path(whole([r["grads"] for r in checks]))
    want = leaves_by_path(jax_side["grads"])
    assert set(got) == set(want)
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], atol=1e-5, rtol=1e-4,
                                   err_msg=str(path))


@pytest.mark.parametrize("case", range(len(RECOVERIES)),
                         ids=[f"{r}-stage{f}" for f, r in RECOVERIES])
def test_in_mesh_recovery_is_bit_equal_to_the_host_merge(checks, jax_side,
                                                         case):
    failed, reinit = RECOVERIES[case]
    cfg = ModelConfig(**CFG)
    params = _tensors(jax_side["params"])
    want = recover_stage(params, StagePartition(cfg, K), failed,
                         torch.tensor(OMEGA_VALUES), strategy=reinit)
    got = TR.map(lambda *xs: np.concatenate(xs),
                 *[r["recovered"][case][0] for r in checks])
    for path, a in leaves_by_path(got).items():
        np.testing.assert_array_equal(
            a, leaves_by_path(_numpy(want["blocks"]))[path], err_msg=path)
    assert all(r["recovered"][case][1] for r in checks)


def host_step(jax_side):
    """The port's host step (``Trainer._body``, CheckFree+) of the masked
    batch from JAX's parameters -> (its record, the parameters after it)."""
    tcfg = TrainConfig(global_batch=8, microbatch=4, seq_len=16,
                       optimizer=OptimizerConfig(**OCFG),
                       recovery=RecoveryConfig(strategy="checkfree_plus",
                                               num_stages=K))
    trainer = Trainer(Model(ModelConfig(**CFG), device="cpu", weights=False),
                      tcfg)
    params = TR.map(lambda t: t.requires_grad_(), _tensors(jax_side["params"]))
    opt = init_adam(params)
    batch = {k: torch.as_tensor(v) for k, v in jax_side["masked"].items()}
    row = trainer._body(params, TR.leaves(opt.m), TR.leaves(opt.v), batch,
                        torch.zeros((), dtype=torch.int32),
                        torch.ones((), dtype=torch.float32)).numpy()
    return row, leaves_by_path(_numpy(params))


@pytest.mark.parametrize("against", ["jax", "port_host"])
def test_one_swap_step_under_a_loss_mask(checks, jax_side, against):
    """Parameters: within 1e-5 of the port's host step; against JAX within
    1e-5 beyond the host step's own distance from JAX's, element by element.
    That distance reaches 1.24e-5 on one element of ``wv`` in this step:
    its gradient, -1.25e-7 in JAX and -1.35e-7 in the port (a sum that
    cancels to the level of fp32 rounding), is clipped into Adam's eps
    regime, where a first update moves with the gradient's relative error;
    the pipeline's own microbatch sums do the same."""
    records = [r["record"] for r in checks]
    for rec in records[1:]:
        np.testing.assert_array_equal(rec, records[0])
    got = records[0]
    row, host_params = host_step(jax_side)
    if against == "jax":
        ring = jax_side["ring"]
        want = {k: float(ring[k][0]) for k in ("loss", "ce", "aux",
                                                "grad_norm", "lr")}
        want_omegas = ring["omegas"][0]
        want_params = leaves_by_path(jax_side["step_params"])
        slack = {path: np.abs(host_params[path] - w)
                 for path, w in want_params.items()}
    else:
        want = {k: row[RECORD.index(k)] for k in ("loss", "ce", "aux",
                                                  "grad_norm", "lr")}
        want_omegas = row[OMEGAS:]
        want_params = host_params
        slack = {path: 0.0 for path in want_params}
    for key, value in want.items():
        np.testing.assert_allclose(got[RECORD.index(key)], value, rtol=2e-4,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(got[OMEGAS:], want_omegas, rtol=2e-3)
    stepped = leaves_by_path(whole([r["stepped"] for r in checks]))
    assert set(stepped) == set(want_params)
    for path, w in want_params.items():
        err = np.abs(stepped[path] - w) - slack[path]
        assert err.max() <= 1e-5, (path, float(err.max()))


def test_moe_pipeline_matches_jax_at_one_microbatch(checks, jax_side):
    for r in checks:
        np.testing.assert_allclose(r["moe_loss_m1"], jax_side["moe_loss"],
                                   rtol=2e-5)
    got = leaves_by_path(whole([r["moe_grads"] for r in checks]))
    want = leaves_by_path(jax_side["moe_grads"])
    assert set(got) == set(want) and ("blocks", "mlp", "router") in got
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], atol=1e-5, rtol=1e-4,
                                   err_msg=str(path))


def test_moe_pipeline_at_two_microbatches_takes_their_mean_aux(checks,
                                                               jax_side):
    want = jax_side["moe_ce"] + jax_side["moe_coef"] * float(
        np.mean(jax_side["moe_aux_mb"]))
    for r in checks:
        np.testing.assert_allclose(r["moe_loss_m2"], want, rtol=2e-5)
    # the whole batch's aux differs: routing is per microbatch under GPipe
    assert abs(r["moe_loss_m2"] - jax_side["moe_loss"]) > 1e-6


# ---------------------------------------------------------------------------
# the spawn: a rank that fails fails the run
# ---------------------------------------------------------------------------

def _failing_rank(rank, sleep_s):
    import time
    if rank == 1:
        raise ValueError("rank 1 gives up")
    time.sleep(sleep_s)
    return rank


@pytest.mark.parametrize("case", ["raises", "times_out"])
def test_a_failed_rank_fails_the_run(case, tmp_path):
    """A rank that raises fails the run with its traceback, the others
    killed; a run past its time limit is killed whole."""
    import time
    t0 = time.monotonic()
    if case == "raises":
        with pytest.raises(RuntimeError, match="rank 1 gives up"):
            spawn_stages(_failing_rank, 2, 600.0, workdir=str(tmp_path))
    else:
        with pytest.raises(TimeoutError, match=r"stage ranks \[0\]"):
            spawn_stages(_failing_rank, 1, 600.0, timeout_s=5.0,
                         workdir=str(tmp_path))
    assert time.monotonic() - t0 < 120
