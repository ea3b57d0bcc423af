"""Long-context serving on the CPU: the plain attention over blocks of query
rows, the parameter draw a layer at a time, the ring caches and positions
near 2^19 against JAX, the SSD scan over many chunks, and the one-card
dry-run's arguments against what a real model and cache hold.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
        tests/test_torch_long_context.py

Tolerances: the block-row attention against the whole one 1e-6 x (1 + |w|)
(the same fp32 function, summed in other blocks); JAX parity fp32 1e-4
(``test_torch_model.TOL``), and the port's own RoPE near 2^19 within
LONG_ROPE_TOL of JAX's; the draw's empirical std within 2% of the
truncated normal's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import (close, close_cache, jax_greedy,  # noqa: F401
                              one_torch_thread, pair, prompt)
from repro import configs as JC
from repro.models.layers import rope_freqs as jax_rope_freqs
from repro.models.model import build_model as jax_build_model
from repro_torch import configs as C
from repro_torch import tree as TR
from repro_torch.config import INPUT_SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as DR
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.model import Model, build_model

ROWS_TOL = 1e-6
STD_TOL = 0.02
# the std of N(0, 1) truncated at +-3
TRUNC_STD = math.sqrt(1 - 6 * math.exp(-4.5) / math.sqrt(2 * math.pi)
                      / math.erf(3 / math.sqrt(2)))
# decode from just below 2^19 (long_500k's 524,288 tokens) across it
LONG_POS = 524_280
# the port's own RoPE against JAX's there (ROADMAP §3's rounding gap: 3.5e-3
# in logits, 1.1e-2 in the rotated keys; v is not rotated: JAX parity's 1e-4)
LONG_ROPE_TOL = {"logits": 1e-2, "k": 3e-2, "v": 1e-4}


# ---------------------------------------------------------------------------
# the plain attention over blocks of query rows
# ---------------------------------------------------------------------------

ROWS_CASES = {
    "causal": dict(b=2, hq=4, hkv=4, sq=96, sk=96, d=32, causal=True,
                   window=0),
    "window": dict(b=2, hq=4, hkv=4, sq=96, sk=96, d=32, causal=True,
                   window=20),
    "gqa": dict(b=2, hq=8, hkv=2, sq=96, sk=96, d=16, causal=True,
                window=33),
    "mqa": dict(b=1, hq=6, hkv=1, sq=96, sk=96, d=16, causal=True, window=0),
    "full_sq_ne_sk": dict(b=2, hq=4, hkv=2, sq=37, sk=90, d=16,
                          causal=False, window=0),
    "window_not_causal": dict(b=1, hq=4, hkv=2, sq=96, sk=96, d=16,
                              causal=False, window=30),
}


@pytest.mark.parametrize("block", [32, 25])          # divides Sq 96, does not
@pytest.mark.parametrize("case", sorted(ROWS_CASES))
def test_rows_ref_equals_the_whole_plain_attention(case, block):
    c = ROWS_CASES[case]
    rng = np.random.default_rng(sorted(ROWS_CASES).index(case))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((c["b"], c["hq"], c["sq"], c["d"]),
                             (c["b"], c["hkv"], c["sk"], c["d"]),
                             (c["b"], c["hkv"], c["sk"], c["d"])))
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=c["causal"],
                                             window=c["window"])
    got, lse = ref.flash_attention_rows_ref(q, k, v, causal=c["causal"],
                                            window=c["window"], block=block)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert lse.shape == want_lse.shape and lse.dtype == torch.float32
    for g, w in ((got, want), (lse, want_lse)):
        assert bool(((g - w).abs() <= ROWS_TOL * (1 + w.abs())).all()), \
            float((g - w).abs().max())


def test_rows_ref_keeps_bf16_and_the_whole_versions_rounding():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16)
               for s in ((1, 4, 70, 16), (1, 2, 70, 16), (1, 2, 70, 16)))
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=True, window=9)
    got, lse = ref.flash_attention_rows_ref(q, k, v, causal=True, window=9,
                                            block=16)
    assert got.dtype == torch.bfloat16
    # both round one fp32 result to bf16: at most one bf16 ulp apart
    assert bool(((got.float() - want.float()).abs()
                 <= 2 ** -7 * want.float().abs() + 1e-6).all())
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-6)


def test_rows_ref_refuses_an_empty_block():
    q = torch.zeros((1, 1, 4, 16))
    with pytest.raises(ValueError, match="block"):
        ref.flash_attention_rows_ref(q, q, q, block=0)


# ---------------------------------------------------------------------------
# the parameter draw, a layer at a time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_draw_is_a_truncated_normal_of_the_stated_std(dtype):
    std = 0.05
    t = L._trunc_normal(torch.Generator().manual_seed(0), (6, 256, 700), std,
                        dtype, "cpu")
    assert t.dtype == dtype and t.shape == (6, 256, 700)
    x = t.float()
    # bf16 rounds the bound by at most half an ulp
    assert float(x.abs().max()) <= 3 * std * (1 + 2 ** -8)
    assert abs(float(x.std()) / (TRUNC_STD * std) - 1) <= STD_TOL
    assert abs(float(x.mean())) <= 0.01 * std
    # every layer drawn, none a copy of another
    assert len({float(layer.sum()) for layer in x}) == 6


def test_draw_gives_the_same_bits_for_the_same_seed():
    def draw(seed, dtype):
        return L._trunc_normal(torch.Generator().manual_seed(seed),
                               (3, 40, 50), 0.1, dtype, "cpu")
    assert torch.equal(draw(1, torch.bfloat16), draw(1, torch.bfloat16))
    assert not torch.equal(draw(1, torch.float32), draw(2, torch.float32))
    # a bf16 draw is the fp32 draw rounded (the generator's stream is the
    # same whatever the result's dtype)
    assert torch.equal(draw(1, torch.bfloat16),
                       draw(1, torch.float32).to(torch.bfloat16))
    m = Model(C.reduced(C.get_config("qwen3-4b")), device="cpu",
              generator=torch.Generator().manual_seed(3))
    m2 = Model(C.reduced(C.get_config("qwen3-4b")), device="cpu",
               generator=torch.Generator().manual_seed(3))
    for a, b in zip(TR.leaves(m.params), TR.leaves(m2.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(8, 64, 96), (5, 3, 32, 16), (300, 40)])
def test_draw_holds_the_result_and_one_layers_fp32(shape):
    """Under the dry-run's live-byte counter: the result in bf16 plus one
    slice of axis 0 in fp32 for a stacked leaf (the whole leaf for a 2-D
    one)."""
    with DR.LiveBytes([]) as live:
        t = L._trunc_normal(torch.Generator().manual_seed(0), shape, 0.02,
                            torch.bfloat16, "cpu")
    layer = t[0].numel() if len(shape) >= 3 else t.numel()
    assert live.peak <= t.numel() * 2 + layer * 4, (live.peak, t.numel())


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-1.3b", "zamba2-2.7b",
                                  "granite-moe-3b-a800m", "whisper-large-v3",
                                  "internvl2-76b"])
def test_model_builds_on_meta_with_the_shapes_of_a_real_build(arch):
    cfg = C.reduced(C.get_config(arch))
    meta = DR.param_tree(cfg, dtype=cfg.dtype)
    real = Model(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0)).params
    got = {p: (tuple(t.shape), t.dtype, t.device.type)
           for p, t in TR.leaves_with_path(meta)}
    want = {p: (tuple(t.shape), t.dtype, "meta")
            for p, t in TR.leaves_with_path(real)}
    assert got == want
    jmodel = jax_build_model(JC.reduced(JC.get_config(arch)))
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    assert sorted(tuple(s.shape) for s in jax.tree.leaves(jshapes)) == \
        sorted(s for s, _, _ in got.values())


# ---------------------------------------------------------------------------
# the ring caches and long positions against JAX
# ---------------------------------------------------------------------------

def test_swa_serving_ring_on_a_model_with_no_window_matches_jax():
    """long_500k's dense variant: qwen3-4b has no sliding window; it serves
    from a ring of ``window`` slots.  A prompt of exactly the window fills
    it, and the first decode step wraps (slot 0)."""
    window = 16
    model, jmodel, jparams = pair("qwen3-4b", dtype="float32")
    assert model.cfg.sliding_window == 0
    toks = prompt(model.cfg, 2, window, seed=6)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, window)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     window)
    close(logits, jlogits)
    close_cache(cache, jcache)
    for _ in range(6):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(
            cache, torch.from_numpy(np.array(nxt)), window=window)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt,
                                             window=window)
        close(logits, jlogits)
        close_cache(cache, jcache)
    got = serve.generate(model, torch.from_numpy(toks), new_tokens=6,
                         window=window)
    np.testing.assert_array_equal(
        got.tokens, jax_greedy(jmodel, jparams, toks, 6, window=window))


HYBRID_RING = 8


def hybrid_swa_ring_against_jax(window: int = HYBRID_RING) -> None:
    """long_500k's hybrid variant (native-ssm+swa-shared-attn): zamba2-2.7b
    reduced to 4 SSM layers with the shared block after every 2, no
    sliding window of its own, prefills a prompt of ``window`` tokens into a
    ring of that capacity, then decodes 2 * window + 3 tokens with
    ``window=`` (the ring wraps at the first step and twice more) while the
    SSM states carry on; logits, the ring's K/V and ``pos``, and the SSM
    and conv states held to JAX's at 1e-4 after every step."""
    model, jmodel, jparams = pair("zamba2-2.7b", dtype="float32",
                                  num_layers=4, attn_every=2)
    assert model.cfg.sliding_window == 0
    toks = prompt(model.cfg, 2, window, seed=8)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, window)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     window)
    close(logits, jlogits)
    close_cache(cache, jcache)
    for _ in range(2 * window + 3):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(
            cache, torch.from_numpy(np.array(nxt)), window=window)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt,
                                             window=window)
        close(logits, jlogits)
        close_cache(cache, jcache)
        close(cache["ssm"], jcache["ssm"])
        close(cache["conv"], jcache["conv"])
    assert int(cache["pos"][0]) == 3 * window + 3


def test_hybrid_swa_serving_ring_matches_jax():
    hybrid_swa_ring_against_jax()


def test_hybrid_swa_serving_ring_refuses_a_slot_off_by_one(monkeypatch):
    """The same comparison fails where each decode step writes its K/V one
    ring slot past ``pos % window`` (and so evicts the second oldest key,
    keeping one that left the window)."""
    decode = L.attention_decode

    def off_by_one(p, x, pos, cache_k, cache_v, cfg, **kw):
        for c in (cache_k, cache_v):
            c.copy_(c.roll(-1, dims=1))
        out = decode(p, x, pos, cache_k, cache_v, cfg, **kw)
        for c in (cache_k, cache_v):
            c.copy_(c.roll(1, dims=1))
        return out

    monkeypatch.setattr(L, "attention_decode", off_by_one)
    with pytest.raises(AssertionError):
        hybrid_swa_ring_against_jax()


def jax_jit_rope_freqs(head_dim, theta, device):
    """JAX's RoPE frequencies as its jitted model computes them."""
    return torch.from_numpy(np.array(
        jax.jit(jax_rope_freqs, static_argnums=(0, 1))(head_dim, theta))
    ).to(device)


@pytest.mark.parametrize("window", [8, 7])
def test_decode_across_2_19_matches_jax_given_its_rope_frequencies(
        window, monkeypatch):
    """Decode from position 524,280 across 2^19 (long_500k's dense variant:
    a ring of ``window`` slots, filled by a prompt of the window, on a
    cache whose ``pos`` is then set the same in both; 524,280 is slot 0 of
    a ring of 8 and slot 1 of a ring of 7).  The angles are fp32 products
    pos x freq in both packages; JAX's jitted frequencies need not be the
    correctly rounded ones the port holds
    (:func:`test_rope_frequencies_are_correctly_rounded`; XLA's fused
    power decides), and at these
    positions one ulp of a frequency moves an angle by up to 0.03 rad, so
    JAX's are carried into the port here and the rest is held at 1e-4."""
    monkeypatch.setattr(L, "rope_freqs", jax_jit_rope_freqs)
    model, jmodel, jparams = pair("qwen3-4b", dtype="float32")
    toks = prompt(model.cfg, 2, window, seed=5)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, window)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     window)
    cache["pos"].fill_(LONG_POS)
    jcache = dict(jcache, pos=jnp.full_like(jcache["pos"], LONG_POS))
    for _ in range(12):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(
            cache, torch.from_numpy(np.array(nxt)), window=window)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt,
                                             window=window)
        close(logits, jlogits)
        close_cache(cache, jcache)
    assert int(cache["pos"][0]) == LONG_POS + 12 > 2 ** 19


def own_rope_gap_across_2_19(window: int) -> dict:
    """Decode from LONG_POS across 2^19 with the port's own frequencies
    (``rope_freqs`` as it stands), tokens from JAX's argmax: the largest
    |port - JAX| of the logits and of the cache's k and v."""
    model, jmodel, jparams = pair("qwen3-4b", dtype="float32")
    toks = prompt(model.cfg, 2, window, seed=5)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, window)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     window)
    cache["pos"].fill_(LONG_POS)
    jcache = dict(jcache, pos=jnp.full_like(jcache["pos"], LONG_POS))
    worst = dict.fromkeys(LONG_ROPE_TOL, 0.0)
    for _ in range(12):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(
            cache, torch.from_numpy(np.array(nxt)), window=window)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt,
                                             window=window)
        for key, got, want in (("logits", logits, jlogits),
                               ("k", cache["k"], jcache["k"]),
                               ("v", cache["v"], jcache["v"])):
            err = float(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32)).max())
            worst[key] = max(worst[key], err)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert int(cache["pos"][0]) == LONG_POS + 12 > 2 ** 19
    return worst


@pytest.mark.parametrize("window", [8, 7])
def test_decode_across_2_19_with_the_ports_own_rope_stays_near_jax(window):
    """The same decode with the port's own frequencies (``rope_freqs``,
    rounded once from float64), which may differ from JAX's jitted ones
    by ulps (ROADMAP §3: a fp32 formula's ulps moved logits by 3.5e-3
    and the rotated keys by 1.1e-2 at these positions); held within
    LONG_ROPE_TOL, just above that gap."""
    worst = own_rope_gap_across_2_19(window)
    assert all(worst[k] <= LONG_ROPE_TOL[k] for k in worst), worst


def test_decode_across_2_19_refuses_a_rope_fault(monkeypatch):
    """LONG_ROPE_TOL is tight enough for a fault of the port's RoPE at
    long positions: frequencies off by 2**-18 of themselves (the angle at
    2^19 off by ~2 rad at the fastest) move the logits past it."""
    own = L.rope_freqs
    monkeypatch.setattr(L, "rope_freqs", lambda d, theta, device:
                        own(d, theta, device) * (1 + 2 ** -18))
    worst = own_rope_gap_across_2_19(8)
    assert worst["logits"] > LONG_ROPE_TOL["logits"], worst


def test_rope_frequencies_are_correctly_rounded():
    """The port's frequencies are theta^(-2i/D) rounded once from float64,
    on every device alike (``layers.rope_freqs``)."""
    for head_dim, theta in ((64, 1e6), (128, 1e6), (120, 1e4), (256, 1e4),
                            (80, 1e4)):
        got = L.rope_freqs(head_dim, theta, "cpu")
        exps = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
        want = (1.0 / theta ** exps).astype(np.float32)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_mamba2_over_64_chunks_matches_jax():
    """The SSD scan of a prompt of 64 chunks (T 1,024 at the reduced
    chunk of 16), prefill and decode, fp32."""
    jcfg = JC.reduced(JC.get_config("mamba2-1.3b")).replace(dtype="float32")
    cfg = C.reduced(C.get_config("mamba2-1.3b")).replace(dtype="float32")
    t = 64 * cfg.ssm.chunk_size
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"), device="cpu")
    toks = prompt(cfg, 2, t, seed=7)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, t + 4)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     t + 4)
    close(logits, jlogits)
    for key in ("ssm", "conv"):
        close(cache[key], jcache[key])
    for _ in range(4):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(cache,
                                          torch.from_numpy(np.array(nxt)))
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt)
        close(logits, jlogits)
        close(cache["ssm"], jcache["ssm"])


# ---------------------------------------------------------------------------
# the one-card estimate's arguments against a real model and cache
# ---------------------------------------------------------------------------

def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in TR.leaves(tree))


# (arch, shape, batch, seq, prefill capacity or None): every serving
# variant of JAX's decode_plan, and the prefills generate runs
VARIANTS = {
    "prefill-full": ("qwen3-4b", "prefill_32k", 2, 40, 48),
    "prefill-ring": ("h2o-danube-3-4b", "prefill_32k", 2, 40, 16),
    "prefill-ssm": ("mamba2-1.3b", "prefill_32k", 2, 48, None),
    "full-cache": ("qwen3-4b", "decode_32k", 2, 48, None),
    "swa-serving": ("qwen3-4b", "long_500k", 2, 4096, None),
    "native-swa": ("h2o-danube-3-4b", "long_500k", 2, 4096, None),
    "native-ssm": ("mamba2-1.3b", "decode_32k", 2, 4096, None),
    "native-ssm+swa-shared-attn": ("zamba2-2.7b", "long_500k", 2, 4096,
                                   None),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_one_card_estimate_holds_the_bytes_of_the_real_model_and_cache(
        variant):
    arch, shape, batch, seq, capacity = VARIANTS[variant]
    cfg = C.reduced(C.get_config(arch))
    if arch == "h2o-danube-3-4b":
        cfg = cfg.replace(sliding_window=16)
    rec = DR.run_one(arch, shape, mesh="1x1", cfg=cfg, batch=batch, seq=seq,
                     capacity=capacity, with_cost=False, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    plan = DR.plan_for(cfg, INPUT_SHAPES[shape], batch=batch, seq=seq,
                       capacity=capacity)
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    held = nbytes(model.params)
    if plan["kind"] == "prefill":
        toks = torch.from_numpy(prompt(cfg, batch, plan["text"]))
        logits, cache = model.prefill({"tokens": toks}, plan["capacity"])
        assert rec["memory"]["argument_B"] == held + nbytes(toks)
        assert rec["memory"]["output_B"] == nbytes(logits) + nbytes(cache)
    else:
        assert rec["variant"] == variant
        toks = torch.from_numpy(prompt(cfg, batch, 8))
        _, cache = model.prefill({"tokens": toks}, max(plan["capacity"], 8))
        nxt = torch.zeros((batch,), dtype=torch.int32)
        assert rec["memory"]["argument_B"] == held + nbytes(cache) + \
            nbytes(nxt)


def test_plan_for_takes_a_prefill_capacity_only():
    cfg = C.reduced(C.get_config("qwen3-4b"))
    plan = DR.plan_for(cfg, INPUT_SHAPES["prefill_32k"], batch=1, seq=100,
                       capacity=132)
    assert (plan["seq"], plan["capacity"]) == (100, 132)
    assert DR.plan_for(cfg, INPUT_SHAPES["prefill_32k"], batch=1,
                       seq=100)["capacity"] == 100
    with pytest.raises(ValueError, match="capacity"):
        DR.plan_for(cfg, INPUT_SHAPES["decode_32k"], capacity=8)
