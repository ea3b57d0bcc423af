"""The port's dense layers against ``repro.models.layers``, in fp32.

Inputs and parameters are made with numpy from a seed and fed to both
packages; parameters cross through ``repro_torch.convert``.  Tolerance 2e-5
(fp32, the two frameworks sum in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import layers as JL
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L

TOL = dict(atol=2e-5, rtol=2e-5)


def cfgs(arch, **kw):
    """The same reduced fp32 config from both packages."""
    return (reduced(get_config(arch)).replace(dtype="float32", **kw),
            jax_reduced(jax_get_config(arch)).replace(dtype="float32", **kw))


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


def jax_params(tree):
    return jax.tree.map(np.asarray, tree)


def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    jx, tx = both(x)
    tp = params_from_numpy(p, device="cpu")
    jp = jax.tree.map(jnp.asarray, p)
    close(L.rmsnorm(tp, tx, 1e-6), JL.rmsnorm(jp, jx, 1e-6))
    close(L.layernorm(tp, tx), JL.layernorm(jp, jx))


def test_rmsnorm_keeps_bf16():
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    out = L.rmsnorm({"scale": torch.ones(64)}, x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 12)).astype(np.int32)
    jx, tx = both(x)
    close(L.apply_rope(tx, torch.from_numpy(pos), theta),
          JL.apply_rope(jx, jnp.asarray(pos), theta))


@pytest.mark.parametrize("arch,window", [("paper-llama-124m", 0),
                                         ("qwen3-4b", 0), ("qwen3-4b", 5)])
def test_attention_full_sequence(arch, window):
    cfg, jcfg = cfgs(arch)
    jp = JL.init_attention(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = params_from_numpy(jax_params(jp), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    jx, tx = both(x)
    mask = JL.swa_mask(11, 11, window) if window else JL.causal_mask(11, 11)
    want, (jk, jv) = JL.attention(jp, jx, jnp.asarray(pos), jcfg, mask=mask,
                                  return_kv=True)
    got, (k, v) = L.attention(tp, tx, torch.from_numpy(pos), cfg,
                              window=window, return_kv=True)
    close(got, want)
    close(k, jk)
    close(v, jv)


@pytest.mark.parametrize("arch,window", [("paper-llama-124m", 0),
                                         ("qwen3-4b", 0), ("qwen3-4b", 8)])
def test_attention_decode(arch, window):
    cfg, jcfg = cfgs(arch)
    jp = JL.init_attention(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = params_from_numpy(jax_params(jp), device="cpu")
    rng = np.random.default_rng(3)
    cap = 8 if window else 16
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([5, 13, 2], np.int32) if window else np.array([5, 9, 0],
                                                                  np.int32)
    shape = (3, cap, cfg.num_kv_heads, cfg.resolved_head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    want, jck, jcv = JL.attention_decode(jp, jnp.asarray(x), jnp.asarray(pos),
                                         jnp.asarray(ck), jnp.asarray(cv),
                                         jcfg, window=window)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, nck, ncv = L.attention_decode(tp, torch.from_numpy(x),
                                       torch.from_numpy(pos), tck, tcv, cfg,
                                       window=window)
    assert nck is tck and ncv is tcv       # written in place
    close(got, want)
    close(nck, jck)
    close(ncv, jcv)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlps(act, gated):
    cfg, jcfg = cfgs("paper-llama-124m", act=act, gated_mlp=gated)
    init = JL.init_mlp if gated else JL.init_mlp_plain
    jp = init(jax.random.PRNGKey(4), cfg.d_model, cfg.d_ff, jnp.float32)
    tp = params_from_numpy(jax_params(jp), device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 7, cfg.d_model))
    jx, tx = both(x.astype(np.float32))
    close(L.apply_mlp(tp, tx, cfg), JL.apply_mlp(jp, jx, jcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_and_unembed_softcap(dtype):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 64)).astype(np.float32)
    w = rng.standard_normal((64, 50)).astype(np.float32)
    toks = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    jt = {"table": jnp.asarray(table).astype(dtype)}
    tt = params_from_numpy({"table": table}, device="cpu",
                           dtype=getattr(torch, dtype))
    emb = L.embed(tt, torch.from_numpy(toks), scale=True)
    jemb = JL.embed(jt, jnp.asarray(toks), scale=True)
    assert emb.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(emb.float().numpy(),
                                  np.asarray(jemb, np.float32))
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jx, tx = both(x)
    ttab = params_from_numpy({"table": table}, device="cpu")
    close(L.unembed(ttab, tx, 30.0), JL.unembed({"table": jnp.asarray(table)},
                                                jx, 30.0))
    close(L.unembed_w({"w": torch.from_numpy(w)}, tx, 30.0),
          JL.unembed_w({"w": jnp.asarray(w)}, jx, 30.0))
