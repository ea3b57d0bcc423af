"""The MoE family of the port against the JAX package, on the CPU.

Layer level (``repro_torch.models.moe`` against ``repro.models.moe``), on
the reduced granite-moe-3b-a800m (E 4, top-2, GQA 4/2) and deepseek-moe-16b
(E 4, top-2, one shared expert) and a granite-shaped reduced config with E 8,
k 3; inputs drawn with numpy from a seed:

* ``_group_size`` over lengths and a ``REPRO_MOE_GROUP`` cap;
* ``topk_dispatch`` (the one-hot form): dispatch and combine bit-equal, aux
  within 1e-6, with a capacity that bites, k = 1, tied gates from zero rows
  (``jax.lax.top_k`` puts the lower index first) and bf16;
* ``moe_mlp`` (the index form): ``topi`` and ``keep`` equal to JAX's, out
  within 1e-5 of max |out| in fp32 and 1e-2 in bf16, aux within 1e-6;
* the index form against the port's one-hot form: the experts' inputs
  bit-equal, the output within one bf16 ulp (both sum the same k fp32
  products, in different orders, and round once), and the same bits on a
  second run, backward included;
* gradients of x and of every leaf, router included, against ``jax.grad``
  within 1e-4 of each gradient's largest magnitude (fp32).

Model level: prefill and teacher-forced decode against JAX (greedy tokens
equal, logits within 1e-3, fp32), decode against the full forward at
capacity factor 16 (no drops: decode groups one token a group), the
converter's round trip of an MoE tree, and ``Model`` built leaf by leaf in
the compute dtype equal to the whole fp32 tree cast afterwards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import moe as JM
from repro.models.model import build_model as jax_build_model
from repro_torch import configs as C
from repro_torch import tree as TR
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model import Model

ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
# (arch, MoE changes): the reduced configs, and granite with E 8, k 3
LAYER_CASES = [("granite-moe-3b-a800m", {}), ("deepseek-moe-16b", {}),
               ("granite-moe-3b-a800m", dict(num_experts=8, top_k=3))]
LAYER_IDS = ["granite", "deepseek", "granite-e8k3"]
OUT_REL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_REL = 1e-4
MODEL_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(arch, moe=None, **kw):
    """(JAX config, port config): ``reduced`` with MoE and other changes."""
    out = []
    for pkg in (JC, C):
        cfg = pkg.reduced(pkg.get_config(arch))
        if moe:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
        out.append(cfg.replace(**kw))
    return out


def jdt(name):
    return jnp.float32 if name == "float32" else jnp.bfloat16


def tdt(name):
    return L.to_dtype(name)


def as_np(t):
    """A tensor or JAX array as fp32 numpy (bf16 values are exact in fp32)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def layer_pair(arch, moe, dtype, seed=0):
    """(JAX cfg, port cfg, JAX layer params, port layer params), both in
    ``dtype`` (the router too, as the model's cast leaves it)."""
    jcfg, cfg = configs(arch, moe)
    jp = JM.init_moe_layer(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    jp = jax.tree.map(lambda a: a.astype(jdt(dtype)), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def inputs(cfg, b, s, dtype, seed=1, zero_rows=0):
    """x (B, S, d) from numpy, its first ``zero_rows`` tokens zero (uniform
    gates: every expert ties)."""
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
    x = x.astype(np.float32)
    x[:, :zero_rows] = 0.0
    jx = jnp.asarray(x).astype(jdt(dtype))
    return jx, torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        tdt(dtype))


# ---------------------------------------------------------------------------
# grouping and the one-hot dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, "64", "3", "1"])
def test_group_size_matches_jax(cap, monkeypatch):
    if cap is None:
        monkeypatch.delenv("REPRO_MOE_GROUP", raising=False)
    else:
        monkeypatch.setenv("REPRO_MOE_GROUP", cap)
    for b in (1, 3):
        for s in (1, 2, 7, 12, 48, 96, 512, 1000, 4096, 8192, 12288):
            assert M._group_size(b * s, s) == JM._group_size(b * s, s), (b, s)


def gates_from(seed, g, t, e, zero_rows):
    logits = np.random.default_rng(seed).normal(size=(g, t, e))
    logits[:, :zero_rows] = 0.0
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))
    return gates


DISPATCH_CASES = {
    # (G, T, E, k, capacity factor, dtype, zero rows)
    "granite": (2, 16, 4, 2, 1.25, "float32", 0),
    "bites": (2, 16, 4, 2, 0.5, "float32", 0),
    "k1": (3, 8, 8, 1, 1.25, "float32", 0),
    "ties": (2, 12, 8, 3, 1.25, "float32", 5),
    "ties-bites": (1, 16, 8, 3, 0.5, "float32", 16),
    "bf16": (2, 16, 8, 3, 1.25, "bfloat16", 2),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_topk_dispatch_matches_jax(case):
    g, t, e, k, cf, dtype, zero_rows = DISPATCH_CASES[case]
    gates = gates_from(3, g, t, e, zero_rows)
    if zero_rows:
        assert (gates[:, :zero_rows] == gates[0, 0, 0]).all()
    cap = max(1, int(np.ceil(t * k / e * cf)))
    jd, jc, jaux = JM.topk_dispatch(jnp.asarray(gates), k, cap, jdt(dtype))
    d, c, aux = M.topk_dispatch(torch.from_numpy(gates.copy()), k, cap,
                                 tdt(dtype))
    assert d.dtype == c.dtype == tdt(dtype)
    np.testing.assert_array_equal(as_np(d), as_np(jd))
    np.testing.assert_array_equal(as_np(c), as_np(jc))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    if cf < 1:                          # the capacity bites: some drops
        assert as_np(jd).sum() < g * t * k


def test_ties_take_the_lower_expert_first():
    gates = torch.full((1, 2, 6), 1 / 6)
    topv, topi = M.top_k(gates, 3)
    assert topi.tolist() == [[[0, 1, 2], [0, 1, 2]]]
    jv, ji = jax.lax.top_k(jnp.asarray(gates.numpy()), 3)
    assert np.asarray(ji).tolist() == topi.tolist()


# ---------------------------------------------------------------------------
# the index form
# ---------------------------------------------------------------------------

def jax_routing(jp, jx, jcfg):
    """JAX's topi and keep (G, T, k), read off its one-hot dispatch."""
    m = jcfg.moe
    b, s, d = jx.shape
    tg = JM._group_size(b * s, s)
    xg = jx.reshape(b * s // tg, tg, d)
    gates = jax.nn.softmax(xg.astype(jnp.float32)
                           @ jp["router"].astype(jnp.float32), axis=-1)
    cap = max(1, int(np.ceil(tg * m.top_k / m.num_experts
                             * m.capacity_factor)))
    dispatch, _, _ = JM.topk_dispatch(gates, m.top_k, cap, jnp.float32)
    _, topi = jax.lax.top_k(gates, m.top_k)
    topi = np.asarray(topi)
    placed = np.asarray(dispatch).sum(-1)                    # (G, T, E)
    keep = np.take_along_axis(placed, topi, -1) > 0
    return topi, keep


def port_routing(tp, tx, cfg):
    b, s, d = tx.shape
    tg = M._group_size(b * s, s)
    r = M.route(tp, tx.reshape(b * s // tg, tg, d), cfg, M.capacity(tg, cfg))
    return r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(LAYER_CASES)), ids=LAYER_IDS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_mlp_matches_jax(case, dtype, cf):
    arch, moe = LAYER_CASES[case]
    jcfg, cfg, jp, tp = layer_pair(arch, dict(moe, capacity_factor=cf), dtype)
    jx, tx = inputs(cfg, 2, 24, dtype, zero_rows=1)
    jout, jaux = JM.moe_mlp(jp, jx, jcfg)
    out, aux = M.moe_mlp(tp, tx, cfg)
    assert out.dtype == tdt(dtype) and out.shape == tx.shape
    topi, keep = jax_routing(jp, jx, jcfg)
    r = port_routing(tp, tx, cfg)
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if cf < 1:
        assert not keep.all()
    want = as_np(jout)
    np.testing.assert_allclose(as_np(out), want, rtol=0,
                               atol=OUT_REL[dtype] * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    assert ("shared" in tp) == (cfg.moe.num_shared_experts > 0)


def bf16_ulp(a):
    """One bf16 ulp of each |a| (2**-7 of its power of two)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("case", range(len(LAYER_CASES)), ids=LAYER_IDS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_index_form_matches_one_hot_form(case, cf):
    arch, moe = LAYER_CASES[case]
    _, cfg, _, tp = layer_pair(arch, dict(moe, capacity_factor=cf),
                               "bfloat16")
    _, tx = inputs(cfg, 2, 24, "bfloat16", zero_rows=3)
    b, s, d = tx.shape
    tg = M._group_size(b * s, s)
    g, cap = b * s // tg, M.capacity(tg, cfg)
    xg = tx.reshape(g, tg, d)
    # the experts' inputs: the gather against the one-hot einsum
    r = M.route(tp, xg, cfg, cap)
    src, dst = M.slot_maps(r, cap)
    ein = M._Dispatch.apply(tx.reshape(-1, d), src, dst)
    dispatch, _, _ = M.topk_dispatch(r.gates, cfg.moe.top_k, cap, tx.dtype)
    want_ein = torch.einsum("gtd,gtec->gecd", xg, dispatch)
    np.testing.assert_array_equal(
        ein.view(cfg.moe.num_experts, g, cap, d).transpose(0, 1).float()
        .numpy(), want_ein.float().numpy())
    # the output: the same k products in two orders, each rounded once
    out, aux = M.moe_mlp(tp, tx, cfg)
    want, want_aux = M.moe_mlp_onehot(tp, tx, cfg)
    o, w = as_np(out), as_np(want)
    assert (np.abs(o - w) <= bf16_ulp(np.maximum(np.abs(o), np.abs(w)))).all()
    assert float(aux) == float(want_aux)
    # two runs, forward and backward: the same bits
    runs = []
    for _ in range(2):
        leaves = TR.map(lambda t: t.detach().float().requires_grad_(), tp)
        x = tx.detach().float().requires_grad_()
        out, aux = M.moe_mlp(TR.map(lambda t: t.to(torch.bfloat16), leaves),
                             x.to(torch.bfloat16), cfg)
        (out.float().square().sum() + aux).backward()
        runs.append([out.float(), x.grad] + [t.grad for t in
                                             TR.leaves(leaves)])
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def grad_pair(arch, moe, seed=0):
    """Gradients of x and of every leaf of sum(out * r) + 0.5 * aux, JAX
    and port, fp32."""
    jcfg, cfg, jp, tp = layer_pair(arch, moe, "float32", seed)
    jx, tx = inputs(cfg, 2, 16, "float32", zero_rows=1)
    r = np.random.default_rng(9).normal(size=tx.shape).astype(np.float32)

    def jf(p, x):
        out, aux = JM.moe_mlp(p, x, jcfg)
        return jnp.sum(out * r) + 0.5 * aux

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jx)
    leaves = TR.map(lambda t: t.detach().requires_grad_(), tp)
    x = tx.detach().requires_grad_()
    out, aux = M.moe_mlp(leaves, x, cfg)
    (torch.sum(out * torch.from_numpy(r)) + 0.5 * aux).backward()
    return (jgp, jgx), (leaves, x)


def close_rel(got, want, rel, name=""):
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


@pytest.mark.parametrize("case", range(len(LAYER_CASES)), ids=LAYER_IDS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_gradients_match_jax(case, cf):
    arch, moe = LAYER_CASES[case]
    (jgp, jgx), (leaves, x) = grad_pair(arch, dict(moe, capacity_factor=cf))
    close_rel(x.grad.numpy(), np.asarray(jgx), GRAD_REL, "x")
    jleaves = {tuple(k.key for k in path): np.asarray(v) for path, v in
               jax.tree_util.tree_flatten_with_path(jgp)[0]}
    got = dict(TR.leaves_with_path(leaves))
    assert set(got) == set(jleaves) and ("router",) in got
    for path, leaf in got.items():
        close_rel(leaf.grad.numpy(), jleaves[path], GRAD_REL, "/".join(path))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def model_pair(arch, **kw):
    jcfg, cfg = configs(arch, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return Model(cfg, tparams, device="cpu"), jmodel, jparams


def prompt(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def close(t, j, tol=MODEL_TOL):
    np.testing.assert_allclose(as_np(t), as_np(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    model, jmodel, jparams = model_pair(arch, dtype="float32")
    cfg = model.cfg
    toks = prompt(cfg, 2, 12)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     20)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, 20)
    close(logits, jlogits)
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])
    nxt = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)
    assert logits[:, -1].argmax(-1).tolist() == nxt.tolist()
    for _ in range(4):            # teacher-forced with JAX's greedy tokens
        jlogits, jcache = jmodel.decode_step(jparams, jcache,
                                             jnp.asarray(nxt))
        logits, cache = model.decode_step(cache, torch.from_numpy(nxt))
        close(logits, jlogits)
        nxt = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)
        assert logits[:, -1].argmax(-1).tolist() == nxt.tolist()
    lg, aux = model.apply({"tokens": torch.from_numpy(toks)})
    jlg, jaux = jmodel.apply(jparams, {"tokens": jnp.asarray(toks)})
    close(lg, jlg)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_without_drops(arch):
    """Decode groups one token a group (C = 1, no drops since the choices
    are distinct experts); at capacity factor 16 the prefill drops nothing
    either, so decode equals the full forward."""
    model, _, _ = model_pair(arch, dtype="float32", moe=dict(
        capacity_factor=16.0))
    cfg = model.cfg
    toks = torch.from_numpy(prompt(cfg, 2, 12, seed=3))
    nxt = torch.tensor([3, 4], dtype=torch.int32)
    _, cache = model.prefill({"tokens": toks}, 16)
    logits, _ = model.decode_step(cache, nxt)
    full, _ = model.apply({"tokens": torch.cat([toks, nxt[:, None]], 1)})
    close(logits[:, 0], full[:, -1], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_round_trips_an_moe_tree(arch):
    jcfg, cfg = configs(arch)
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tree, device="cpu")
    fresh = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    assert [p for p, _ in TR.leaves_with_path(tparams)] == \
        [p for p, _ in TR.leaves_with_path(fresh)]
    for (path, a), (_, b) in zip(TR.leaves_with_path(tparams),
                                 TR.leaves_with_path(fresh)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    mlp = tparams["blocks"]["mlp"]
    e, d = cfg.moe.num_experts, cfg.d_model
    assert mlp["w_gate"].shape == (2, e, d, cfg.moe.d_ff_expert)
    assert mlp["router"].shape == (2, d, e)
    back = params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-4b", "zamba2-2.7b"])
def test_model_built_leaf_by_leaf_equals_whole_tree_cast(arch):
    """``Model`` draws each leaf and casts it at once; the values are those
    of the whole fp32 tree drawn from the same seed and cast afterwards."""
    cfg = C.reduced(C.get_config(arch))
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    whole = L.cast_tree(model.init(torch.Generator().manual_seed(5)),
                        cfg.dtype)
    assert TR.leaves(whole)[0].dtype == torch.bfloat16
    got = model.params
    assert [p for p, _ in TR.leaves_with_path(got)] == \
        [p for p, _ in TR.leaves_with_path(whole)]
    for a, b in zip(TR.leaves(got), TR.leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving with several routing groups a row
# ---------------------------------------------------------------------------

SERVE_GROUP, SERVE_PROMPT = "64", 256       # 4 groups a row of the prompt


def serve_routing_against_jax(arch, monkeypatch) -> None:
    """Prefill of a 256-token prompt under ``REPRO_MOE_GROUP`` 64 (4
    routing groups a row, as prefill_32k's 32,768 tokens route in 8 groups
    of 4,096), then 4 teacher-forced decode steps, fp32: every MoE layer's
    ``topi`` and ``keep`` equal to JAX's, layer by layer and step by step
    (JAX's read off its one-hot dispatch, its layer scan unrolled so that
    each layer runs on its own), and the logits within 1e-4."""
    monkeypatch.setenv("REPRO_MOE_GROUP", SERVE_GROUP)
    monkeypatch.setenv("REPRO_UNROLL_SCAN", "1")
    model, jmodel, jparams = model_pair(arch, dtype="float32")
    cfg = model.cfg
    got, want = [], []
    route, dispatch = M.route, JM.topk_dispatch

    def port_recorded(p, xg, cfg, cap):
        r = route(p, xg, cfg, cap)
        got.append((r.topi.numpy(), r.keep.numpy()))
        return r

    def jax_recorded(gates, k, capacity, dtype):
        out = dispatch(gates, k, capacity, dtype)
        _, topi = jax.lax.top_k(gates, k)
        topi = np.asarray(topi)
        placed = np.asarray(out[0], np.float32).sum(-1)      # (G, T, E)
        want.append((topi, np.take_along_axis(placed, topi, -1) > 0))
        return out

    monkeypatch.setattr(M, "route", port_recorded)
    monkeypatch.setattr(JM, "topk_dispatch", jax_recorded)
    toks = prompt(cfg, 2, SERVE_PROMPT, seed=11)
    capacity = SERVE_PROMPT + 4
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)},
                                  capacity)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     capacity)
    close(logits, jlogits, 1e-4)
    groups = 2 * SERVE_PROMPT // int(SERVE_GROUP)
    assert [t.shape for t, _ in want] == \
        [(groups, int(SERVE_GROUP), cfg.moe.top_k)] * cfg.num_layers
    for _ in range(4):          # teacher-forced with JAX's greedy tokens
        nxt = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache,
                                             jnp.asarray(nxt))
        logits, cache = model.decode_step(cache, torch.from_numpy(nxt))
        close(logits, jlogits, 1e-4)
    assert len(got) == len(want) == 5 * cfg.num_layers
    for (gt, gk), (wt, wk) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gk, wk)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_with_several_groups_a_row_matches_jax(arch, monkeypatch):
    serve_routing_against_jax(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_groups_refuse_the_whole_row_as_one_group(arch, monkeypatch):
    """The same comparison fails where the port routes each row of the
    prompt as one group in place of ``_group_size``'s."""
    monkeypatch.setattr(M, "_group_size", lambda total_tokens, seq: seq)
    with pytest.raises(AssertionError):
        serve_routing_against_jax(arch, monkeypatch)
