"""The SSM and hybrid serving slice of the port against the JAX package.

Kernel level: the port's plain versions of the SSD scan (token by token,
``ref.ssd_scan_ref``, and chunked, ``ref.ssd_chunked``) against
``repro.kernels.ref.ssd_scan_ref`` and the Pallas kernel in interpret mode
over the sweep of tests/test_kernels.py, at its tolerances (fp32 1e-4, bf16
3e-2); the final state and a starting state against JAX ``ssd_chunked`` at
1e-4.  Module level: the conv, the one-token recurrence and the mamba2 block
(full sequence with its state, and one-token decode) at 1e-4 in fp32.  Slice
level: reduced mamba2-1.3b and reduced zamba2-2.7b (4 layers, a shared
attention block after every 2) with JAX parameters carried over by the
converter: prefill logits and the whole cache, four teacher-forced decode
steps, greedy generation and the full forward at 1e-4 in fp32, and within
0.05 of the largest |logit| in bf16 (tests/test_smoke_archs.py's limit).
Also the refusals: no device but the CPU's and CUDA's.  Training these
families is held against JAX in tests/test_torch_ssm_train.py.  The CUDA kernels are held
against these plain versions on the card in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ref as JR
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import ssm as JS
from repro.models.model import build_model as jax_build_model
from repro_torch import configs as C
from repro_torch import tree as TRE
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch import serve
from repro_torch.models import ssm as S
from repro_torch.models.model import Model, build_model

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
HYBRID = dict(num_layers=4, attn_every=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ssd_arrays(seed, b, h, t, p, g, n):
    """tests/test_kernels.py's draws, kernel layout, in numpy: x (B, H, T, P),
    a (B, H, T) = -0.1 |N(0, 1)|, B and C (B, G, T, N)."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((b, h, t, p))
    a = -0.1 * np.abs(rng.standard_normal((b, h, t)))
    bm = 0.4 * rng.standard_normal((b, g, t, n))
    cm = 0.4 * rng.standard_normal((b, g, t, n))
    return [v.astype(np.float32) for v in (x, a, bm, cm)]


def to_torch(arrs, dtype="float32"):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def to_jax(arrs, dtype="float32"):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def model_layout(x, a, bm, cm):
    """Kernel layout -> model layout: (B, T, H, P), (B, T, H), (B, T, G, N)."""
    return x.transpose(1, 2), a.transpose(1, 2), bm.transpose(1, 2), \
        cm.transpose(1, 2)


def close(t, j, dtype="float32"):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# the SSD scan's plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,chunk", [(64, 16), (64, 64), (128, 32)])
@pytest.mark.parametrize("h,g", [(2, 1), (4, 2)])
def test_plain_ssd_matches_jax_sweep(t, chunk, h, g):
    arrs = ssd_arrays(7, 2, h, t, 16, g, 8)
    want = JR.ssd_scan_ref(*to_jax(arrs))
    pallas = pallas_ssd_scan(*to_jax(arrs), chunk=chunk, interpret=True)
    tx, ta, tb, tc = to_torch(arrs)
    token, _ = TR.ssd_scan_ref(tx, ta, tb, tc)
    chunked, _ = TR.ssd_chunked(*model_layout(tx, ta, tb, tc), chunk)
    for got in (token, chunked.transpose(1, 2)):
        close(got, want)
        close(got, pallas)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ssd_dtypes(dtype):
    """bf16 x, B, C; the decay stays fp32 on the port's path (the model's a
    is fp32), which the JAX kernel casts to anyway."""
    arrs = ssd_arrays(9, 1, 2, 64, 8, 1, 4)
    jx, _, jb, jc = to_jax(arrs, dtype)
    ja = jnp.asarray(arrs[1])
    want = JR.ssd_scan_ref(jx, ja, jb, jc)
    pallas = pallas_ssd_scan(jx, ja, jb, jc, chunk=32, interpret=True)
    tx, _, tb, tc = to_torch(arrs, dtype)
    ta = torch.from_numpy(arrs[1])
    token, _ = TR.ssd_scan_ref(tx, ta, tb, tc)
    chunked, _ = TR.ssd_chunked(*model_layout(tx, ta, tb, tc), 32)
    for got in (token, chunked.transpose(1, 2)):
        assert got.dtype == getattr(torch, dtype)
        close(got, want, dtype)
        close(got, pallas, dtype)


@pytest.mark.parametrize("t,chunk", [(64, 16), (9, 3), (9, 4)])
@pytest.mark.parametrize("with_init", [False, True])
def test_plain_ssd_states_match_jax_ssd_chunked(t, chunk, with_init):
    """Final state and a starting state against JAX ``ssd_chunked``.  T = 9
    with chunk 3 is the JAX choice for a 9-token prompt (the largest divisor
    <= chunk_size); chunk 4 leaves a ragged last chunk, which the port pads
    with tokens that carry nothing (JAX refuses it: held against JAX's
    chunk 3 and the token-by-token definition)."""
    x, a, bm, cm = ssd_arrays(11, 2, 4, t, 8, 2, 4)
    rng = np.random.default_rng(12)
    init = (0.5 * rng.standard_normal((2, 4, 8, 4))).astype(np.float32) \
        if with_init else None
    mx, ma, mb, mc = (np.moveaxis(v, 2, 1) for v in (x, a, bm, cm))
    jchunk = chunk if t % chunk == 0 else 3
    jy, jstate = JS.ssd_chunked(*to_jax([mx, ma, mb, mc]), jchunk,
                                None if init is None else jnp.asarray(init))
    tinit = None if init is None else torch.from_numpy(init)
    y, state = TR.ssd_chunked(*to_torch([mx, ma, mb, mc]), chunk, tinit)
    ty, tstate = TR.ssd_scan_ref(*to_torch([x, a, bm, cm]), tinit)
    for got_y, got_state in ((y, state), (ty.transpose(1, 2), tstate)):
        close(got_y, jy)
        close(got_state, jstate)
        assert got_state.dtype == torch.float32


def test_plain_ssd_state_carry_matters():
    """tests/test_kernels.py:220 for the port: dropping the carried state
    between chunks changes y, and two halves chained through init_state
    give the whole."""
    x, a, bm, cm = model_layout(*to_torch(ssd_arrays(8, 1, 1, 64, 8, 1, 4)))
    full, state = TR.ssd_chunked(x, a, bm, cm, 16)
    parts = [TR.ssd_chunked(x[:, i:i + 16], a[:, i:i + 16], bm[:, i:i + 16],
                            cm[:, i:i + 16], 16)[0] for i in range(0, 64, 16)]
    assert float((full - torch.cat(parts, dim=1)).abs().max()) > 1e-3
    y1, s1 = TR.ssd_chunked(x[:, :32], a[:, :32], bm[:, :32], cm[:, :32], 16)
    y2, s2 = TR.ssd_chunked(x[:, 32:], a[:, 32:], bm[:, 32:], cm[:, 32:], 16,
                            s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), full, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(s2, state, atol=1e-5, rtol=1e-5)


def test_plain_ssd_has_no_nan_at_the_real_decay_range():
    """a down to -8 a token: exp(cs_i - cs_j) above the diagonal is inf in
    fp32.  The forward and the gradient stay finite."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((1, 64, 2, 8)).astype(np.float32))
    a = torch.from_numpy(-8 * rng.random((1, 64, 2)).astype(np.float32))
    bm = torch.from_numpy(rng.standard_normal((1, 64, 1, 4)).astype(np.float32))
    x.requires_grad_()
    y, state = ops.ssd_scan(x, a, bm, bm, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    (y.sum() + state.sum()).backward()
    assert torch.isfinite(x.grad).all()


def test_ops_ssd_scan_on_cpu_is_the_chunked_plain_version():
    x, a, bm, cm = model_layout(*to_torch(ssd_arrays(14, 2, 4, 32, 8, 2, 4)))
    y, state = ops.ssd_scan(x, a, bm, cm, chunk=16)
    wy, ws = TR.ssd_chunked(x, a, bm, cm, 16)
    torch.testing.assert_close(y, wy, atol=0, rtol=0)
    torch.testing.assert_close(state, ws, atol=0, rtol=0)
    assert S.ssd_chunked is TR.ssd_chunked


def test_ops_ssd_scan_raises_off_cpu_and_cuda():
    """Another device raises; meta takes the kernel's meta branch."""
    shapes = ((1, 16, 2, 8), (1, 16, 2), (1, 16, 1, 4))
    x, a, bm = (torch.empty(s).as_subclass(_Elsewhere) for s in shapes)
    with pytest.raises(ValueError, match="xpu"):
        ops.ssd_scan(x, a, bm, bm, chunk=16)
    x, a, bm = (torch.empty(s, device="meta") for s in shapes)
    before = SSD.launches
    y, final = ops.ssd_scan(x, a, bm, bm, chunk=16)
    assert y.shape == x.shape and final.shape == (1, 2, 8, 4)
    assert SSD.launches == before


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports another device, ``xpu``, for which the port
    has no kernel and no plain version."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__self__", None) is torch.Tensor.device:
            return torch.device("xpu")
        return super().__torch_function__(func, types, args, kwargs or {})


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    x, a, bm, cm = model_layout(*to_torch(ssd_arrays(15, 1, 2, 16, 8, 1, 4)))
    before = SSD.launches
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_scan(x, a, bm, cm, chunk=16)
    assert SSD.launches == before


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's numeric design (csrc/ssd_scan.cu), emulated
# ---------------------------------------------------------------------------

def _bf16(v):
    return v.to(torch.bfloat16).float()


SPLIT = ("att", "state", "xw")


def _product(lhs, rhs, split):
    """lhs @ rhs, fp32 accumulation, rhs bf16 already; lhs rounded to bf16
    once or, with ``split``, split into a bf16 high part and the bf16
    rounding of what it leaves, two products."""
    hi = _bf16(lhs)
    return hi @ rhs + _bf16(lhs - hi) @ rhs if split else hi @ rhs


def ssd_bf16_emulated(xb, a, bmat, cmat, chunk, init_state=None, *,
                      split=SPLIT):
    """The chunked scan rounded where the bf16 kernel rounds, model layout.

    x, B and C are bf16; every product accumulates in fp32 and the state
    stays fp32.  The three operands the kernel forms in fp32 are the decayed
    C B^T (``att``), the state copy read by the inter-chunk term (``state``)
    and x w, w_j = exp(cs_last - cs_j), of the state update (``xw``): those
    named in ``split`` are split into bf16 hi + lo, as the kernel splits all
    three; the others are rounded to bf16 once.  y is rounded to bf16.
    """
    b, t, h, p = xb.shape
    r = h // bmat.shape[2]
    x = xb.float().transpose(1, 2)                                # b h t p
    bm = bmat.float().repeat_interleave(r, 2).transpose(1, 2)     # b h t n
    cm = cmat.float().repeat_interleave(r, 2).transpose(1, 2)
    af = a.float().transpose(1, 2)                                # b h t
    state = (torch.zeros((b, h, p, bmat.shape[3])) if init_state is None
             else init_state.float())
    ys = []
    for t0 in range(0, t, chunk):
        sl = slice(t0, min(t0 + chunk, t))
        xc, bc, cc = x[:, :, sl], bm[:, :, sl], cm[:, :, sl]
        cs = torch.cumsum(af[:, :, sl], -1)
        q = cs.shape[-1]
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool))
        expo = torch.where(mask, cs[..., :, None] - cs[..., None, :], 0.0)
        att = torch.where(mask, (cc @ bc.transpose(-1, -2)) * torch.exp(expo),
                          0.0)
        # C S^T as (S C^T)^T, so that the state is the split operand
        inter = _product(state, cc.transpose(-1, -2), "state" in split)
        ys.append(_product(att, xc, "att" in split)
                  + torch.exp(cs)[..., None] * inter.transpose(-1, -2))
        xw = xc * torch.exp(cs[..., -1:] - cs)[..., None]
        state = torch.exp(cs[..., -1])[..., None, None] * state \
            + _product(xw.transpose(-1, -2), bc, "xw" in split)
    y = torch.cat(ys, dim=2).transpose(1, 2)
    return y.to(xb.dtype), state


def real_decay_arrays(seed, b, t, h, p, n, init=False):
    """Model layout, numpy: mamba2's decay a = dt A (dt = softplus(N(0, 1)
    + dt_bias), A = -linspace(1, 16, H), down to about -1.6 a token), xb =
    N(0, 1) dt and B, C N(0, 1) rounded to bf16 (one group), and a starting
    state 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    dt0 = np.exp(rng.random(h) * (np.log(1e-1) - np.log(1e-3)) + np.log(1e-3))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) + dt_bias))
    a = (dt * -np.linspace(1.0, 16.0, h)).astype(np.float32)
    bf = lambda v: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    xb = bf(rng.standard_normal((b, t, h, p)) * dt[..., None])
    bm = bf(rng.standard_normal((b, t, 1, n)))
    cm = bf(rng.standard_normal((b, t, 1, n)))
    init_state = (0.5 * rng.standard_normal((b, h, p, n))).astype(np.float32) \
        if init else None
    return xb, torch.from_numpy(a), bm, cm, init_state


def emulated_vs_jax(seed, b, t, h, p, n, init, split=SPLIT):
    """(max |y error| / (1 + |y|), the same for the state) of the emulation
    against JAX ``ssd_chunked`` at chunk 64."""
    xb, a, bm, cm, init_state = real_decay_arrays(seed, b, t, h, p, n, init)
    j = lambda v: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
    jy, js = JS.ssd_chunked(j(xb), jnp.asarray(a.numpy()), j(bm), j(cm), 64,
                            None if init_state is None
                            else jnp.asarray(init_state))
    y, state = ssd_bf16_emulated(
        xb, a, bm, cm, 64,
        None if init_state is None else torch.from_numpy(init_state),
        split=split)
    jy = torch.from_numpy(np.array(jy.astype(jnp.float32)))
    js = torch.from_numpy(np.array(js))
    rel = lambda got, want: float(((got.float() - want).abs()
                                   / (1 + want.abs())).max())
    return rel(y, jy), rel(state, js)


@pytest.mark.parametrize("b,n", [(1, 128), (2, 64), (2, 128)])
@pytest.mark.parametrize("init", [False, True])
def test_bf16_kernel_rounding_points_match_jax(b, n, init):
    """The tensor-core kernel's rounding points (att, the state copy and x w
    split into bf16 hi + lo, fp32 accumulators, y rounded to bf16) at
    mamba2's decay, T 512, P 64, chunk 64, against JAX ``ssd_chunked`` at the
    kernel's tolerances: y 3e-2 (1 + |w|), the final state 1e-4 (1 + |w|)."""
    y_err, state_err = emulated_vs_jax(17, b, 512, 4, 64, n, init)
    assert y_err <= 3e-2
    assert state_err <= 1e-4


# ---------------------------------------------------------------------------
# modules against JAX (fp32)
# ---------------------------------------------------------------------------

def block_pair(seed=0):
    """A reduced mamba2 config and one block's parameters, JAX and port."""
    jcfg = JC.reduced(JC.get_config("mamba2-1.3b")).replace(dtype="float32")
    cfg = C.reduced(C.get_config("mamba2-1.3b")).replace(dtype="float32")
    jbp = JS.init_mamba_block(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # a non-zero conv bias, so that it is tested
    jbp["conv_b"] = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                            jbp["conv_b"].shape)
    tbp = params_from_numpy(jax.tree.map(np.asarray, jbp), device="cpu")
    return cfg, jcfg, tbp, jbp


def test_conv1d_full_and_decode_match_jax():
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    tx, tw, tb, tst = to_torch([x, w, b, st])
    close(S.causal_conv1d(tx, tw, tb), JS.causal_conv1d(*to_jax([x, w, b])))
    y, new = S.conv1d_decode(tx[:, 0], tst, tw, tb)
    jy, jnew = JS.conv1d_decode(*to_jax([x[:, 0], st, w, b]))
    close(y, jy)
    close(new, jnew)


def test_ssd_recurrent_step_matches_jax():
    rng = np.random.default_rng(17)
    state = rng.standard_normal((2, 4, 8, 6)).astype(np.float32)
    x = rng.standard_normal((2, 4, 8)).astype(np.float32)
    dt = rng.random((2, 4)).astype(np.float32) * 0.1
    a_log = np.log(np.linspace(1, 16, 4)).astype(np.float32)
    bm = rng.standard_normal((2, 2, 6)).astype(np.float32)
    cm = rng.standard_normal((2, 2, 6)).astype(np.float32)
    arrs = [state, x, dt, a_log, bm, cm]
    y, new = S.ssd_recurrent_step(*to_torch(arrs))
    jy, jnew = JS.ssd_recurrent_step(*to_jax(arrs))
    close(y, jy)
    close(new, jnew)


@pytest.mark.parametrize("t", [16, 9, 2])
def test_mamba_block_with_state_matches_jax(t):
    """9 tokens: chunk 9 of chunk_size 16; 2 tokens: a conv tail shorter
    than the conv's 3 inputs, zeros in front."""
    cfg, jcfg, tbp, jbp = block_pair()
    x = np.random.default_rng(18).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    out, (state, tail) = S.mamba_block(tbp, torch.from_numpy(x), cfg,
                                       return_state=True)
    jout, (jstate, jtail) = JS.mamba_block(jbp, jnp.asarray(x), jcfg,
                                           return_state=True)
    close(out, jout)
    close(state, jstate)
    close(tail, jtail)
    plain = S.mamba_block(tbp, torch.from_numpy(x), cfg)
    torch.testing.assert_close(plain, out, atol=0, rtol=0)


def test_mamba_block_from_a_state_and_decode_match_jax():
    cfg, jcfg, tbp, jbp = block_pair(3)
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    _, nheads, conv_ch, _, n = S.block_dims(cfg)
    init = rng.standard_normal((2, nheads, cfg.ssm.head_dim, n)
                               ).astype(np.float32)
    out, (state, _) = S.mamba_block(tbp, torch.from_numpy(x), cfg,
                                    init_state=torch.from_numpy(init),
                                    return_state=True)
    jout, (jstate, _) = JS.mamba_block(jbp, jnp.asarray(x), jcfg,
                                       init_state=jnp.asarray(init),
                                       return_state=True)
    close(out, jout)
    close(state, jstate)
    conv = rng.standard_normal((2, cfg.ssm.conv_width - 1, conv_ch)
                               ).astype(np.float32)
    got = S.mamba_block_decode(tbp, torch.from_numpy(x[:, :1]), cfg,
                               torch.from_numpy(init), torch.from_numpy(conv))
    want = JS.mamba_block_decode(jbp, jnp.asarray(x[:, :1]), jcfg,
                                 jnp.asarray(init), jnp.asarray(conv))
    for g, w in zip(got, want):
        close(g, w)


def test_init_mamba_block_draws_the_jax_distributions():
    cfg = C.reduced(C.get_config("mamba2-1.3b"))
    bp = S.init_mamba_block(torch.Generator().manual_seed(0), cfg,
                            torch.float32, "cpu", 3)
    jbp = JS.init_mamba_block(jax.random.PRNGKey(0), JC.reduced(
        JC.get_config("mamba2-1.3b")), jnp.float32)
    for k, v in jbp.items():
        got, want = (bp[k], v) if k not in ("norm", "gate_norm") else \
            (bp[k]["scale"], v["scale"])
        assert got.shape == (3, *want.shape), k
        assert got.dtype == torch.float32, k
    np.testing.assert_allclose(bp["a_log"][1].numpy(), np.asarray(jbp["a_log"]),
                               rtol=1e-6)
    softplus = torch.nn.functional.softplus(bp["dt_bias"])
    assert float(softplus.min()) >= 1e-3 * (1 - 1e-5)
    assert float(softplus.max()) <= 1e-1 * (1 + 1e-5)
    assert bool((bp["d_skip"] == 1).all()) and bool((bp["conv_b"] == 0).all())


# ---------------------------------------------------------------------------
# the slice against JAX: reduced mamba2-1.3b and zamba2-2.7b
# ---------------------------------------------------------------------------

def pair(arch, **kw):
    """(port model, JAX model, JAX params) on the same weights, on the CPU."""
    if arch == "zamba2-2.7b":
        kw = {**HYBRID, **kw}
    jcfg = JC.reduced(JC.get_config(arch)).replace(**kw)
    cfg = C.reduced(C.get_config(arch)).replace(**kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return build_model(cfg, tparams, device="cpu"), jmodel, jparams


def prompt(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def close_cache(cache, jcache):
    assert cache.keys() == jcache.keys()
    for k in cache:
        if k == "pos":
            np.testing.assert_array_equal(cache[k].numpy(),
                                          np.asarray(jcache[k]))
        else:
            assert cache[k].shape == jcache[k].shape, k
            close(cache[k], jcache[k])


def jax_greedy(jmodel, jparams, toks, new_tokens):
    capacity = toks.shape[1] + new_tokens
    logits, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   capacity)
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    out = [nxt]
    for _ in range(new_tokens - 1):
        logits, cache = jmodel.decode_step(jparams, cache, nxt)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        out.append(nxt)
    return np.stack([np.asarray(t) for t in out], axis=1)


ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [12, 32])
def test_prefill_and_teacher_forced_decode_match_jax(arch, s):
    """12 tokens: chunk 12; 32 tokens: two chunks of 16, the state carried."""
    model, jmodel, jparams = pair(arch, dtype="float32")
    toks = prompt(model.cfg, 2, s)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, s + 8)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     s + 8)
    assert logits.shape == (2, 1, model.cfg.vocab_size)
    close(logits, jlogits)
    close_cache(cache, jcache)
    for _ in range(4):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(cache,
                                          torch.from_numpy(np.array(nxt)))
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt)
        close(logits, jlogits)
        close_cache(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches_jax(arch):
    model, jmodel, jparams = pair(arch, dtype="float32")
    toks = prompt(model.cfg, 3, 10, seed=1)
    got = serve.generate(model, torch.from_numpy(toks), new_tokens=8)
    assert got.tokens.shape == (3, 8) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens,
                                  jax_greedy(jmodel, jparams, toks, 8))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    model, jmodel, jparams = pair(arch, dtype="float32")
    toks = prompt(model.cfg, 2, 16, seed=2)
    logits, aux = model.apply({"tokens": torch.from_numpy(toks)})
    jlogits, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(toks)})
    assert logits.shape == (2, 16, model.cfg.vocab_size)
    assert float(aux) == 0.0
    close(logits, jlogits)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_decode_and_forward_close_to_jax(arch):
    model, jmodel, jparams = pair(arch)               # dtype bfloat16
    assert model.params["embed"]["table"].dtype == torch.bfloat16
    # every floating leaf in bf16, as JAX's cast_tree makes a_log, dt_bias
    # and d_skip
    blocks = model.params["blocks" if arch == "mamba2-1.3b" else "mamba"]
    assert blocks["dt_bias"].dtype == torch.bfloat16
    toks = prompt(model.cfg, 2, 12, seed=5)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, 16)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
    step, _ = model.decode_step(cache, torch.from_numpy(np.array(nxt)))
    jstep, _ = jmodel.decode_step(jparams, jcache, nxt)
    full, _ = model.apply({"tokens": torch.from_numpy(toks)})
    jfull, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(toks)})
    for got, want in ((logits, jlogits), (step, jstep), (full, jfull)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err / (np.abs(want).max() + 1e-6) < 0.05, err


def test_hybrid_ring_cache_matches_jax():
    """A sliding window on the shared block: prompt 12 into a ring of
    capacity 8 (the dense prefill's ring placement), then ring decode."""
    model, jmodel, jparams = pair("zamba2-2.7b", dtype="float32",
                                  sliding_window=8)
    toks = prompt(model.cfg, 2, 12, seed=4)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, 8)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 8)
    close(logits, jlogits)
    close_cache(cache, jcache)
    for _ in range(3):
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        logits, cache = model.decode_step(
            cache, torch.from_numpy(np.array(nxt)), window=8)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, nxt, window=8)
        close(logits, jlogits)
        close_cache(cache, jcache)


# ---------------------------------------------------------------------------
# entry points and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    res = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--new-tokens", "3"])
    assert res.tokens.shape == (2, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_families_refuse_training(arch):
    """Both families refused to train until the SSD scan had a backward;
    now ``loss`` runs on them with a gradient and ``weights=False`` builds
    a trainer's model (tests/test_torch_ssm_train.py holds both against
    JAX)."""
    cfg = C.reduced(C.get_config(arch))
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "labels": torch.zeros((1, 8), dtype=torch.int32)}
    params = TRE.map(lambda t: t.detach().float().requires_grad_(),
                     model.params)
    loss, metrics = model.loss(params, batch)
    assert loss.grad_fn is not None and torch.isfinite(loss)
    assert float(metrics["aux"]) == 0.0
    trainer_model = Model(cfg, device="cpu", weights=False)
    assert trainer_model.family is model.family
    with pytest.raises(RuntimeError, match="weights=False"):
        trainer_model.params


def test_flash_forward_plain_at_head_dim_80_matches_jax():
    """zamba2-2.7b's shared attention: 32 heads of 80 (here 4, S 37)."""
    rng = np.random.default_rng(20)
    arrs = [rng.standard_normal((2, 4, 37, 80)).astype(np.float32)
            for _ in range(3)]
    out, _ = TR.flash_attention_ref(*to_torch(arrs), causal=True)
    want = JR.flash_attention_ref(*to_jax(arrs), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_head_dim_80_is_built_forward_only():
    """Head dim 80 (zamba2's shared attention) was built for the forward
    only until the backward kernels were redesigned; now both directions
    take it: a CPU tensor gets past the head-dim check in each and is
    refused for its device."""
    q = torch.zeros((1, 2, 16, 80))
    with pytest.raises(ValueError, match="CUDA"):     # past the head-dim check
        FA._check("flash_attention_fwd", q, q, q, 0)
    for what in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        with pytest.raises(ValueError, match="CUDA"):
            FA._check(what, q, q, q, 0, FA.BWD_HEAD_DIMS, do=q)
    assert 80 in FA.FWD_HEAD_DIMS and 80 in FA.BWD_HEAD_DIMS


if __name__ == "__main__":
    # The rounding study behind csrc/ssd_scan.cu's split products: the
    # emulated kernel against JAX at T 512, P 64, chunk 64, seed 0, with all
    # three operands split (the kernel), att and the state copy rounded once,
    # and x w rounded once.
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ssm.py
    for b, h, n, init in ((2, 8, 128, False), (2, 8, 64, False),
                          (2, 32, 128, False), (2, 16, 128, True)):
        for split in (SPLIT, ("xw",), ("att", "state")):
            y_err, state_err = emulated_vs_jax(0, b, 512, h, 64, n, init,
                                               split)
            print(f"B {b} H {h} N {n} init {init} split {'+'.join(split)}: "
                  f"y {y_err:.3e} state {state_err:.3e}")
