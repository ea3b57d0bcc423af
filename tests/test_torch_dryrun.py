"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX one, on
the CPU.

Held equal to JAX: ``SKIPS``, ``decode_plan`` and each pair's plan
(capacity, window, variant, tokens a step), ``model_flops``, and the
sharding specs of every leaf of every architecture's full-size parameter
tree (``jax.eval_shape``), batch and cache on the 16 x 16 and 2 x 16 x 16
meshes, baseline and ``REPRO_PARAM_SHARD=fsdp``.  The prefill's FLOPs
outside the kernels within 1% of the ``dot_general`` FLOPs of JAX's jaxpr
less JAX's attention einsums (and the MoE one-hot dispatch and combine,
which the port's index form does not multiply); the kernels' credits equal
``kernels.cost``'s formulas; remat adds exactly one forward of the
checkpointed blocks; FLOPs and temp bytes grow linearly with depth; the
meta branches launch nothing; ``kernels.cost`` gives chip_smoke's earlier
bounds at the shapes of ``PERF.md`` §6; ``--smoke`` runs with no JAX.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` and
``REPRO_UNROLL_SCAN`` process-wide: the fixture initialises JAX's backend
first and restores ``os.environ`` after the import.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as JCS
from repro.config import INPUT_SHAPES as JSHAPES
from repro.launch import shardings as JSH
from repro.models.model import build_model as jax_build_model
from repro_torch import configs as CS
from repro_torch import tree as TR
from repro_torch.config import INPUT_SHAPES
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun as DR
from repro_torch.launch import perf
from repro_torch.launch import shardings as SH
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.model import Model
from repro_torch.models.transformer import swa_flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun``, imported with the backend already up and
    ``os.environ`` restored afterwards."""
    jax.devices()
    saved = dict(os.environ)
    try:
        from repro.launch import dryrun
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return dryrun


class _FakeMesh:
    """The JAX functions read only ``axis_names`` and ``shape``."""

    def __init__(self, spec: SH.MeshSpec):
        self.axis_names = spec.axis_names
        self.shape = dict(spec.shape)


MESHES = [SH.production_mesh(False), SH.production_mesh(True)]


def norm(spec):
    """A spec with 1-tuples written as the bare axis name, as
    ``PartitionSpec`` writes them."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


def jax_tree(arch):
    model = jax_build_model(JCS.get_config(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return model, {tuple(k.key for k in path): (tuple(v.shape),
                                                jax.tree_util.keystr(path))
                   for path, v in jax.tree_util.tree_flatten_with_path(
                       shapes)[0]}


# ---------------------------------------------------------------------------
# plans, specs, model_flops
# ---------------------------------------------------------------------------

def test_skips_and_swa_window_match_jax(jdry):
    assert DR.SKIPS == jdry.SKIPS
    assert DR.SWA_SERVING_WINDOW == jdry.SWA_SERVING_WINDOW


@pytest.mark.parametrize("arch", CS.arch_ids())
def test_plans_and_model_flops_match_jax(arch, jdry, monkeypatch):
    """JAX's ``input_specs`` with its sharding calls passed through (no
    mesh): its plan, and ``model_flops`` as JAX's ``run_one`` forms it."""
    monkeypatch.setattr(jdry.SH, "batch_shardings", lambda b, m: None)
    monkeypatch.setattr(jdry.SH, "cache_shardings", lambda c, m: None)
    monkeypatch.setattr(jdry.SH, "with_shardings", lambda s, sh: s)
    cfg, jcfg = CS.get_config(arch), JCS.get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        if (arch, name) in DR.SKIPS:
            continue
        if shape.kind == "decode":
            assert DR.decode_plan(cfg, shape) == jdry.decode_plan(
                jcfg, JSHAPES[name])
        _, _, jplan = jdry.input_specs(arch, name, None)
        plan = DR.plan_for(cfg, shape)
        for key, value in jplan.items():
            assert plan[key] == value, (name, key)
        mult = 6 if jplan["kind"] == "train" else 2
        assert DR.useful_flops(cfg, plan) == \
            mult * jcfg.active_param_count() * jplan["tokens_per_step"]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", CS.arch_ids())
def test_param_specs_match_jax_on_every_leaf(arch, fsdp, monkeypatch):
    if fsdp:
        monkeypatch.setenv("REPRO_PARAM_SHARD", "fsdp")
    _, jleaves = jax_tree(arch)
    leaves = {path: tuple(t.shape) for path, t in
              TR.leaves_with_path(DR.param_tree(CS.get_config(arch)))}
    assert leaves == {p: s for p, (s, _) in jleaves.items()}
    for mesh in MESHES:
        fake = _FakeMesh(mesh)
        for path, (shape, keystr) in jleaves.items():
            assert SH.keystr(path) == keystr
            want = norm(JSH.param_spec(shape, fake, path_str=keystr))
            got = norm(SH.param_spec(shape, mesh, path_str=keystr))
            assert got == want, (path, mesh.shape)


@pytest.mark.parametrize("arch", CS.arch_ids())
def test_batch_and_cache_specs_match_jax(arch, jdry):
    cfg = CS.get_config(arch)
    jmodel = jax_build_model(JCS.get_config(arch))
    for name, shape in INPUT_SHAPES.items():
        if (arch, name) in DR.SKIPS:
            continue
        plan = DR.plan_for(cfg, shape)
        b = shape.global_batch
        for mesh in MESHES:
            fake = _FakeMesh(mesh)
            for leaf in DR.batch_inputs(cfg, plan, b).values():
                s = (b, *leaf.shape[1:])
                assert norm(SH.batch_spec(s, mesh)) == \
                    norm(JSH.batch_spec(s, fake)), (name, s)
            if shape.kind != "decode":
                continue
            cap = max(plan["capacity"], 1)
            jcache = jax.eval_shape(lambda: jmodel.init_cache(b, cap))
            cache = Model(cfg, device="meta", weights=False).family.init_cache(
                cfg, b, cap, "meta")
            assert set(cache) == set(jcache)
            for key, leaf in cache.items():
                s = tuple(leaf.shape)
                assert s == tuple(jcache[key].shape), (name, key)
                assert norm(SH.cache_spec(s, mesh)) == \
                    norm(JSH.cache_spec(s, fake)), (name, key)


def test_shard_sizes():
    mesh = SH.production_mesh(True)
    spec = (("pod", "data"), None, "model")
    assert SH.shard_shape((64, 7, 33), spec, mesh) == (2, 7, 3)
    assert SH.shard_bytes((64, 7, 32), 2, spec, mesh) == 2 * 7 * 2 * 2
    assert SH.share((64, 7, 32), spec, mesh) == 1 / 512
    assert SH.one_card_mesh().devices == 1 and mesh.devices == 512


# ---------------------------------------------------------------------------
# FLOPs against JAX's jaxpr
# ---------------------------------------------------------------------------

def _dot_flops(jaxpr) -> int:
    """The dot_general FLOPs of a jaxpr, nested jaxprs included, a scan's
    body times its length."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            out = eqn.outvars[0].aval.shape
            total += 2 * int(np.prod(out)) * int(np.prod(
                [lhs[i] for i in lc]))
        mult = eqn.params.get("length", 1) if eqn.primitive.name == "scan" \
            else 1
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (list, tuple))
                        else [value]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += mult * _dot_flops(inner)
    return total


def _jax_attention_and_dispatch(cfg, b, s) -> int:
    """JAX's full-product attention einsums (4 B H Sq Sk D a call) and the
    MoE one-hot dispatch and combine einsums (4 G T E C d a layer)."""
    h, d = cfg.num_heads, cfg.resolved_head_dim
    if cfg.arch_type == "encdec":
        f = cfg.encoder_seq_len
        return 4 * b * h * d * (cfg.num_encoder_layers * f * f
                                + cfg.num_layers * (s * s + s * f))
    if cfg.arch_type == "vlm":
        s = s + cfg.num_patches
    total = cfg.num_layers * 4 * b * h * s * s * d
    if cfg.arch_type == "moe":
        tg = MOE._group_size(b * s, s)
        g, e = b * s // tg, cfg.moe.num_experts
        total += cfg.num_layers * 4 * g * tg * e * MOE.capacity(tg, cfg) \
            * cfg.d_model
    return total


PREFILL_ARCHS = ["qwen3-4b", "granite-moe-3b-a800m", "whisper-large-v3",
                 "internvl2-76b"]


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_flops_match_jax_jaxpr(arch):
    b, s = 2, 64
    cfg = CS.reduced(CS.get_config(arch))
    jcfg = JCS.reduced(JCS.get_config(arch))
    rec = DR.run_one(arch, "prefill_32k", mesh="1x1", cfg=cfg, batch=b,
                     seq=s, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    ours = rec["cost"]["flops_per_dev"] - rec["cost"]["kernel_flops_per_dev"]
    jmodel = jax_build_model(jcfg)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    plan = DR.plan_for(cfg, INPUT_SHAPES["prefill_32k"], batch=b, seq=s)
    batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.dtype(
        str(v.dtype).replace("torch.", "")))
        for k, v in DR.batch_inputs(cfg, plan, b).items()}
    jaxpr = jax.make_jaxpr(lambda p, bt: jmodel.prefill(p, bt, s))(
        params, batch)
    theirs = _dot_flops(jaxpr.jaxpr) - _jax_attention_and_dispatch(
        cfg, b, plan["text"])
    assert abs(ours - theirs) <= 0.01 * theirs, (ours, theirs)


def test_kernel_credits_equal_the_cost_formulas():
    b, s = 2, 64
    cfg = CS.reduced(CS.get_config("h2o-danube-3-4b")).replace(
        sliding_window=40)
    rec = DR.run_one("h2o-danube-3-4b", "train_4k", mesh="1x1", cfg=cfg,
                     batch=b, seq=s, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    shape = dict(b=b, hq=cfg.num_heads, hkv=cfg.num_kv_heads, s=s, sk=s,
                 d=cfg.resolved_head_dim, itemsize=2, causal=True)
    layers = cfg.num_layers
    want = 0
    for swa in swa_flags(cfg):
        w = cfg.sliding_window if swa else 0
        want += 2 * cost.flash_fwd(**shape, window=w)[1]    # remat: twice
        want += cost.flash_bwd_dq(**shape, window=w)[1]
        want += cost.flash_bwd_dkv(**shape, window=w)[1]
    n = cfg.param_count()
    want += cost.adam_sumsq(n)[1] + cost.adam_update(n)[1]
    assert rec["kernels"] == {"flash_attention_fwd": 2 * layers,
                              "flash_attention_bwd_dq": layers,
                              "flash_attention_bwd_dkv": layers,
                              "adam_sumsq": 1, "adam_update": 1}
    assert rec["cost"]["kernel_flops_per_dev"] == want


# ---------------------------------------------------------------------------
# remat and depth on meta
# ---------------------------------------------------------------------------

def _meta_step(cfg, remat, b=2, s=64):
    model = Model(cfg, device="meta", weights=False)
    params = DR.param_tree(cfg)
    for p in TR.leaves(params):
        p.requires_grad_(True)
    plan = DR.plan_for(cfg, INPUT_SHAPES["train_4k"], batch=b, seq=s)
    step = DR.make_step_fn(model, plan, remat=remat)
    return step, (params, DR.init_state(params),
                  DR.batch_inputs(cfg, plan, b))


def _meta_train(cfg, remat, b=2, s=64):
    step, args = _meta_step(cfg, remat, b, s)
    return DR.measure(step, args, known=DR._tensors(args))


@pytest.mark.parametrize("arch", ["paper-llama-124m", "granite-moe-3b-a800m",
                                  "mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_remat_adds_one_forward_of_the_checkpointed_blocks(arch, monkeypatch):
    """Under "nothing": train FLOPs with remat less those without equal the
    FLOPs of the checkpointed units' recompute, read off the counters as
    each unit runs; each recompute is the unit's forward, stopped once the
    backward has every tensor it needs (non-reentrant checkpointing's early
    stop, as XLA drops a recompute no gradient reads): never more than the
    forward, and more than none."""
    monkeypatch.setenv("REPRO_REMAT", "nothing")
    cfg = CS.reduced(CS.get_config(arch))
    off = _meta_train(cfg, remat=False)["flops"]
    units, counters = [], []
    inner = perf.checkpoint

    def total():
        fc, t = counters
        return fc.get_total_flops() + t.total_flops

    def counting(fn, *args, **kw):
        def counted(*a):
            start = total()
            try:
                return fn(*a)
            finally:     # also when the recompute stops early
                units.append(total() - start)
        return inner(counted, *args, **kw)

    monkeypatch.setattr(perf, "checkpoint", counting)
    step, args = _meta_step(cfg, remat=True)
    with FlopCounterMode(display=False) as fc, cost.tally() as t:
        counters[:] = [fc, t]
        step(*args)
        on = total()
    half = len(units) // 2
    assert half > 0 and len(units) == 2 * half
    forward, again = units[:half], units[half:][::-1]
    assert all(0 < r <= f for f, r in zip(forward, again))
    assert on - off == sum(again)


@pytest.mark.parametrize("arch", ["paper-llama-124m", "mamba2-1.3b"])
def test_flops_and_temp_bytes_grow_linearly_with_depth(arch):
    """Every layer is counted (what JAX's ``scan_util`` unrolls for): FLOPs
    and the live peak grow by the same amount for each 4 layers more.  From
    6 layers on the peak is the end of the backward (every gradient, and
    the stacked bf16 gradient being cast), linear in depth; at 2 it is a
    layer's activations."""
    base = CS.reduced(CS.get_config(arch))
    got = [_meta_train(base.replace(num_layers=n), remat=True)
           for n in (6, 10, 14)]
    flops = [g["flops"] for g in got]
    temp = [g["peak"] for g in got]
    assert flops[2] - flops[1] == flops[1] - flops[0] > 0
    assert temp[2] - temp[1] == temp[1] - temp[0] > 0


def test_dots_keeps_the_flash_forward_and_encdec_keeps_nothing(monkeypatch):
    dense = CS.reduced(CS.get_config("paper-llama-124m"))
    whisper = CS.reduced(CS.get_config("whisper-large-v3"))
    fwd = {}
    for policy in ("nothing", "dots"):
        monkeypatch.setenv("REPRO_REMAT", policy)
        fwd[policy] = (
            _meta_train(dense, True)["kernels"]["flash_attention_fwd"],
            _meta_train(whisper, True)["kernels"]["flash_attention_fwd"])
    layers = dense.num_layers
    e, d = whisper.num_encoder_layers, whisper.num_layers
    assert fwd["nothing"] == (2 * layers, e + 4 * d)
    assert fwd["dots"] == (layers, e + 4 * d)
    peak = {}
    for policy in ("nothing", "dots"):
        monkeypatch.setenv("REPRO_REMAT", policy)
        peak[policy] = _meta_train(dense.replace(num_layers=6), True, b=16,
                                   s=256)["peak"]
    assert peak["dots"] > peak["nothing"]


# ---------------------------------------------------------------------------
# the meta branches and the one home of the counts
# ---------------------------------------------------------------------------

def test_meta_branches_launch_nothing_and_credit_the_kernels():
    before = ops.launch_counts()
    q = torch.empty(2, 16, 4, 64, device="meta", requires_grad=True)
    k = torch.empty(2, 16, 2, 64, device="meta", requires_grad=True)
    v = torch.empty(2, 16, 2, 64, device="meta", requires_grad=True)
    xb = torch.empty(2, 32, 4, 16, device="meta", requires_grad=True)
    a = torch.empty(2, 32, 4, device="meta", requires_grad=True)
    bm = torch.empty(2, 32, 1, 8, device="meta", requires_grad=True)
    leaves = [torch.empty(5, 3, device="meta") for _ in range(4)]
    with cost.tally() as t:
        out = ops.flash_attention(q, k, v, causal=True)
        y, final = ops.ssd_scan(xb, a, bm, bm, chunk=8)
        (out.sum() + y.sum() + final.sum()).backward()
        ops.stage_merge(leaves[:1], leaves[1:2], 0.5, 0.5)
        per_layer, total = ops.adam_sumsq(leaves, [True] * 4, 5)
        ops.adam_update(leaves[:1], leaves[1:2], leaves[2:3], leaves[3:],
                        torch.empty(4, device="meta"), betas=(0.9, 0.999),
                        eps=1e-8, weight_decay=0.0, clip=True)
    assert ops.launch_counts() == before
    assert out.shape == q.shape and q.grad.shape == q.shape
    assert k.grad.shape == k.shape and v.grad.shape == v.shape
    assert y.shape == xb.shape and final.shape == (2, 4, 16, 8)
    assert xb.grad.shape == xb.shape and a.grad.shape == a.shape
    assert per_layer.shape == (5,) and total.shape == ()
    shape = dict(b=2, hq=4, hkv=2, s=16, sk=16, d=64, itemsize=4,
                 causal=True, window=0)
    assert t.flops == {
        "flash_attention_fwd": cost.flash_fwd(**shape)[1],
        "flash_attention_bwd_dq": cost.flash_bwd_dq(**shape)[1],
        "flash_attention_bwd_dkv": cost.flash_bwd_dkv(**shape)[1],
        "ssd_scan": cost.ssd_fwd(2, 32, 4, 16, 1, 8, 8, itemsize=4)[1],
        "ssd_scan_bwd": cost.ssd_bwd(2, 32, 4, 16, 1, 8, 8, itemsize=4)[1],
        "stage_merge": 45, "adam_sumsq": 120, "adam_update": 225}


def test_meta_parameter_tree_draws_nothing():
    gen_state = torch.random.get_rng_state()
    tree = DR.param_tree(CS.get_config("mamba2-1.3b"))
    assert all(t.is_meta for t in TR.leaves(tree))
    assert torch.equal(torch.random.get_rng_state(), gen_state)
    bf16 = DR.param_tree(CS.get_config("qwen3-4b"), dtype="bfloat16")
    assert {t.dtype for t in TR.leaves(bf16)} == {L.to_dtype("bfloat16")}


# chip_smoke's bounds before they moved into kernels.cost, at the shapes of
# PERF.md §6: (bytes, flops), flash at bf16 (B, Hq, Hkv, S, D, window,
# causal, Sk)
FLASH_FWD = [((8, 16, 16, 512, 128, 0, True, 512), (67371008, 8606711808)),
             ((8, 32, 32, 512, 80, 0, True, 512), (84410368, 10758389760)),
             ((8, 32, 8, 512, 120, 4096, True, 512), (79167488, 16137584640)),
             ((8, 8, 1, 512, 256, 0, True, 512), (37879808, 8606711808)),
             ((8, 24, 8, 512, 64, 0, True, 512), (33947648, 6455033856)),
             ((8, 20, 20, 1500, 64, 0, False, 1500),
              (123840000, 92160000000)),
             ((8, 20, 20, 416, 64, 0, False, 1500), (78745600, 25559040000))]
FLASH_BWD = [((4, 16, 16, 512, 128, 0, True, 512),
              (42205184, 6455033856), (50593792, 8606711808)),
             ((4, 8, 1, 512, 256, 0, True, 512),
              (27394048, 6455033856), (21102592, 8606711808)),
             ((4, 32, 8, 512, 120, 4096, True, 512),
              (55574528, 12103188480), (47710208, 16137584640)),
             ((4, 32, 32, 512, 80, 0, True, 512),
              (52953088, 8068792320), (63438848, 10758389760)),
             ((2, 24, 8, 512, 64, 0, True, 512),
              (11730944, 2420637696), (10682368, 3227516928)),
             ((4, 20, 20, 1500, 64, 0, False, 1500),
              (77760000, 69120000000), (93120000, 92160000000)),
             ((4, 20, 20, 448, 64, 0, False, 1500),
              (44769280, 20643840000), (70901760, 27525120000))]
SSD_FWD = [((8, 512, 64, 64, 1, 128), (87031808, 15032385536)),
           ((8, 512, 80, 64, 1, 64), (96731136, 10737418240))]
SSD_BWD = [((8, 512, 64, 64, 1, 128), (106954752, 38654705664)),
           ((4, 512, 80, 64, 1, 64), (65273856, 13421772800))]


def test_cost_formulas_give_chip_smokes_earlier_bounds():
    for (b, h, hkv, s, d, w, causal, sk), want in FLASH_FWD:
        assert cost.flash_fwd(b, h, hkv, s, sk, d, itemsize=2, causal=causal,
                              window=w) == want
    for (b, h, hkv, s, d, w, causal, sk), dq, dkv in FLASH_BWD:
        kw = dict(itemsize=2, causal=causal, window=w)
        assert cost.flash_bwd_dq(b, h, hkv, s, sk, d, **kw) == dq
        assert cost.flash_bwd_dkv(b, h, hkv, s, sk, d, **kw) == dkv
    for shape, want in SSD_FWD:
        assert cost.ssd_fwd(*shape, 64) == want
    for shape, want in SSD_BWD:
        assert cost.ssd_bwd(*shape, 64) == want
    assert cost.stage_merge(202_391_552) == (2428698624, 607174656)
    assert cost.adam_sumsq(1_345_423_360) == (5381693440, 2690846720)
    assert cost.adam_update(1_345_423_360) == (37671854080, 20181350400)


@pytest.mark.parametrize("s,sk,causal,window", [
    (1, None, True, 0), (17, None, True, 5), (100, None, False, 30),
    (512, None, True, 4096), (7, 1, False, 0), (416, 1500, False, 0),
    (33, None, True, 1)])
def test_visible_pairs_count_the_mask(s, sk, causal, window):
    n = s if sk is None else sk
    q, k = np.arange(s)[:, None], np.arange(n)[None, :]
    m = np.ones((s, n), bool)
    if causal:
        m &= k <= q
    if window:
        m &= k > q - window
    assert cost.visible_pairs(s, causal, window, sk) == int(m.sum())


def test_dryrun_smoke_runs_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--smoke']\n"
            "with_jax = 'jax' in sys.modules\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "finally:\n"
            "    assert not with_jax and 'jax' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dry-run smoke OK" in res.stdout
