"""The port's CUDA kernels, model and trainer on the card (tests marked ``gpu``).

Each test skips where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain version on the same inputs at the
tolerances of tests/test_kernels.py (forward fp32 2e-5, bf16 3e-2, lse 1e-4;
backward fp32 2e-4, bf16 3e-2; the merge fp32 1e-6 and one bf16 ulp; the
SSD scan fp32 1e-4, bf16 3e-2, its fp32 final state 1e-4), and the models
and the Trainer on the card against the same on the CPU at 1e-4 (fp32, with
TF32 off; cuBLAS and the CPU sum in different orders).
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models.model import Model

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if request.node.get_closest_marker("gpu") and not torch.cuda.is_available():
        pytest.skip("gpu test: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def qkv(seed, b, hq, hkv, s, d, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device="cuda", dtype=dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("d", FA.FWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(16, 16), (8, 2), (8, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0)])
@pytest.mark.parametrize("s", [1, 63, 64, 200, 1000])
def test_kernel_matches_plain(d, dtype, hq, hkv, causal, window, s):
    """Every head dim the forward is built for (bf16 on the tensor cores,
    fp32 on the CUDA cores), MHA, GQA and MQA, lengths shorter than one tile,
    one tile, ragged and long: every output column below D is written."""
    q, k, v = qkv(0, 2 if s < 1000 else 1, hq, hkv, s, d, dtype)
    before = FA.launches
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)


@pytest.mark.gpu
def test_ops_takes_model_layout_without_copies():
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in qkv(1, 2, 4, 2, 96, 64, torch.bfloat16))
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.shape == q.shape and got.is_contiguous()
    want, _ = ref.flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)))
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(),
                               **TOL[torch.bfloat16])


@pytest.mark.gpu
def test_kernel_refuses_what_it_was_not_built_for():
    q, k, v = qkv(2, 1, 2, 2, 64, 48, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FA.flash_attention_fwd(q, k, v)
    q, k, v = qkv(2, 1, 2, 2, 64, 64, torch.float16)
    with pytest.raises(TypeError):
        FA.flash_attention_fwd(q, k, v)
    # the backward is built for the forward's head dims and refuses others
    q, k, v = qkv(2, 1, 2, 2, 64, 48, torch.bfloat16)
    lse = delta = torch.zeros((1, 2, 64), device="cuda")
    before = (FA.launches_dq, FA.launches_dkv)
    with pytest.raises(NotImplementedError, match="head dim 48"):
        FA.flash_attention_bwd_dq(q, k, v, q, lse, delta)
    with pytest.raises(NotImplementedError, match="head dim 48"):
        FA.flash_attention_bwd_dkv(q, k, v, q, lse, delta)
    assert (FA.launches_dq, FA.launches_dkv) == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch,s", [("qwen3-4b", 37), ("paper-llama-124m", 64),
                                    ("gemma-2b", 37), ("h2o-danube-3-4b", 64)])
def test_model_on_card_matches_cpu(arch, s):
    """gemma-2b and h2o-danube-3-4b keep their real head dims, 256 and 120."""
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    if arch in ("gemma-2b", "h2o-danube-3-4b"):
        cfg = cfg.replace(head_dim=get_config(arch).head_dim)
    params = Model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0)).params
    cpu = Model(cfg, params, device="cpu")
    card = Model(cfg, params, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, s)).astype(np.int32))
    before = FA.launches
    logits, cache = card.prefill({"tokens": toks.cuda()}, s + 4)
    assert FA.launches == before + cfg.num_layers
    want, want_cache = cpu.prefill({"tokens": toks}, s + 4)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["k"].cpu(), want_cache["k"], atol=1e-4,
                               rtol=1e-4)
    nxt = want[:, -1].argmax(-1).to(torch.int32)
    logits, _ = card.decode_step(cache, nxt.cuda())
    want, _ = cpu.decode_step(want_cache, nxt)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# backward kernels, the autograd Function and the stage merge (training slice)
# ---------------------------------------------------------------------------

# fp32: tests/test_kernels.py's VJP tolerance; bf16: kernel and plain version
# both round an fp32 sum once, in different orders: 3e-2 * (1 + |w|)
GRAD_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
            torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("d", FA.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("s,causal,window", [(128, True, 0), (200, True, 100),
                                             (77, False, 0), (1, True, 0),
                                             (96, False, 40)])
def test_backward_kernels_match_plain(d, dtype, hq, hkv, s, causal, window):
    """Every head dim the backward is built for (bf16 on the tensor cores,
    fp32 on the CUDA cores), MHA, GQA and MQA, one row, ragged, windows:
    every output column below D is written."""
    q, k, v = qkv(4, 2, hq, hkv, s, d, dtype)
    do = qkv(5, 2, hq, hq, s, d, dtype)[0]
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    before = (FA.launches_dq, FA.launches_dkv)
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert (FA.launches_dq, FA.launches_dkv) == (before[0] + 1, before[1] + 1)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), **GRAD_TOL[dtype],
                                   msg=lambda m: f"{name}: {m}")
    # and against PyTorch's autograd through the plain forward
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o, _ = ref.flash_attention_ref(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(o, leaves, do)
    for g, w, name in zip(got, auto, ("dq", "dk", "dv")):
        torch.testing.assert_close(g.float(), w.float(), **GRAD_TOL[dtype],
                                   msg=lambda m: f"{name} (autograd): {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_flash_attention_keeps_the_graph_on_the_card(dtype):
    """The cut-gradient fault: on CUDA, ops.flash_attention must carry a
    grad_fn and give q, k and v the plain version's gradients."""
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in qkv(6, 2, 4, 2, 80, 64, dtype))
    w = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1)).to(dtype)
    card = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*card, causal=True, window=0)
    assert out.requires_grad and out.grad_fn is not None
    (out.float() * w.float()).sum().backward()
    plain = [t.detach().cpu().float().requires_grad_() for t in (q, k, v)]
    want = ops.flash_attention(*plain, causal=True, window=0)
    (want * w.cpu().float()).sum().backward()
    for a, b in zip(card, plain):
        assert a.grad is not None
        torch.testing.assert_close(a.grad.cpu().float(), b.grad,
                                   **GRAD_TOL[dtype])


@pytest.mark.gpu
def test_one_layer_attention_gives_wq_its_gradient():
    """A one-layer attention loss on the card: wq, wk and wv get gradients
    that match the same loss on the CPU (fp32, TF32 off)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = reduced(get_config("qwen3-4b")).replace(dtype="float32")
    p = T.unstack(L.init_attention(torch.Generator().manual_seed(0), cfg,
                                   torch.float32, "cpu", 1), 1)[0]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32))
    pos = torch.arange(48).expand(2, 48)
    grads = {}
    for device in ("cpu", "cuda"):
        leaves = {k_: ({"scale": v_["scale"].to(device)} if isinstance(v_, dict)
                       else v_.detach().to(device).requires_grad_())
                  for k_, v_ in p.items()}
        out = L.attention(leaves, x.to(device), pos.to(device), cfg)
        out.square().mean().backward()
        grads[device] = {k_: leaves[k_].grad for k_ in ("wq", "wk", "wv")}
    for name, g in grads["cuda"].items():
        assert g is not None, name
        torch.testing.assert_close(g.cpu(), grads["cpu"][name], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ca,cb", [(1.0, 0.0), (0.0, 1.0), (0.5, 0.5),
                                   (0.25, 0.75)])
def test_stage_merge_kernel_matches_plain(dtype, ca, cb):
    from repro_torch.kernels import stage_merge as SM
    rng = np.random.default_rng(8)
    shapes = [(5,), (8, 1024), (3, 65, 33), (8193,), (2, 4, 8, 16)]
    xs, ys = ([torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(device="cuda", dtype=dtype) for sh in shapes]
              for _ in range(2))
    before = SM.launches
    got = ops.stage_merge(xs, ys, ca, cb)
    torch.cuda.synchronize()
    assert SM.launches == before + 1          # every leaf in one launch
    for x, y, g in zip(xs, ys, got):
        want = ref.stage_merge_ref(x, y, ca, cb)
        assert g.dtype == dtype and g.shape == x.shape
        # fp32: 1e-6 * (1 + |w|) (tests/test_recovery.py:118); bf16: one ulp
        tol = 1e-6 if dtype == torch.float32 else 2 ** -7
        assert bool(((g.float() - want.float()).abs()
                     <= tol * (1 + want.float().abs())).all())


@pytest.mark.gpu
def test_stage_merge_kernel_in_place_on_tower_slices():
    """The recovery path: slices of one stacked leaf, merged into a third
    slice, with a misaligned leaf taking the scalar loop."""
    gen = torch.Generator("cuda").manual_seed(0)
    tower = torch.randn(6, 33, 17, device="cuda", generator=gen)
    flat = torch.randn(1001, device="cuda", generator=gen)
    xs = [tower[0:2], flat[1:334]]
    ys = [tower[4:6], flat[334:667]]
    outs = [tower[2:4], flat[667:1000]]
    want = [ref.stage_merge_ref(x, y, 0.3, 0.7) for x, y in zip(xs, ys)]
    ops.stage_merge(xs, ys, torch.tensor(0.3, device="cuda"),
                    torch.tensor(0.7, device="cuda"), out=outs)
    for o, w in zip(outs, want):
        torch.testing.assert_close(o, w, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="overlaps"):
        ops.stage_merge([tower[0:2]], [tower[4:6]], 0.5, 0.5, out=[tower[1:3]])


@pytest.mark.gpu
def test_one_layer_model_loss_gives_wq_its_gradient():
    """Model.loss of a one-layer model on the card: every attention weight
    gets a gradient, equal to the CPU's (fp32, TF32 off)."""
    from repro_torch import tree as TR
    cfg = reduced(get_config("paper-llama-124m")).replace(num_layers=1,
                                                          dtype="float32")
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(2, 41))
    grads = {}
    for device in ("cpu", "cuda"):
        leaves = TR.map(lambda t: t.detach().to(device).requires_grad_(),
                        params)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(device),
                 "labels": torch.from_numpy(toks[:, 1:]).to(device)}
        loss, _ = Model(cfg, device=device, weights=False).loss(leaves, batch)
        assert loss.grad_fn is not None
        loss.backward()
        grads[device] = leaves["blocks"]["attn"]
    for name in ("wq", "wk", "wv", "wo"):
        assert grads["cuda"][name].grad is not None, name
        torch.testing.assert_close(grads["cuda"][name].grad.cpu(),
                                   grads["cpu"][name].grad, atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["checkfree", "checkfree_plus"])
def test_trainer_on_card_matches_cpu(strategy):
    """8 reduced layers, 4 stages, fp32: the Trainer on the card (kernels)
    against the CPU (plain versions) through merges, an edge stage and a
    consecutive run; every merge launches the merge kernel once."""
    from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches
    from repro_torch.kernels import stage_merge as SM

    class Forced:
        def at(self, step):
            return {3: [2], 5: [0], 7: [1, 2]}.get(step, [])

    cfg = get_config("paper-llama-124m").replace(
        num_layers=8, d_model=128, num_heads=4, num_kv_heads=4, d_ff=344,
        vocab_size=512, max_seq_len=64, dtype="float32")
    tcfg = TrainConfig(global_batch=8, microbatch=8, seq_len=64, steps=10,
                       fuse_window=1, optimizer=OptimizerConfig(
                           lr=6e-4, total_steps=10),
                       recovery=RecoveryConfig(strategy=strategy,
                                               num_stages=4))
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    hists = {}
    for device in ("cuda", "cpu"):
        before = SM.launches
        trainer = Trainer(Model(cfg, device=device, weights=False), tcfg,
                          schedule=Forced())
        _, hists[device] = trainer.run(make_batches(cfg, batch=8, seq=64),
                                       params=params)
        if device == "cuda":
            assert SM.launches - before == 3      # steps 3 and 7 (two)
    assert hists["cuda"].failures == hists["cpu"].failures
    np.testing.assert_allclose(hists["cuda"].loss, hists["cpu"].loss,
                               rtol=1e-4)
    np.testing.assert_allclose([e for _, e in hists["cuda"].recovery_errors],
                               [e for _, e in hists["cpu"].recovery_errors],
                               rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-2b", "h2o-danube-3-4b"])
def test_real_head_dim_models_train_on_card_as_on_cpu(arch):
    """2 layers of gemma-2b (MQA, head dim 256) and h2o-danube-3-4b (GQA,
    head dim 120, window 4096) at full width, fp32: two Adam steps of the
    Trainer on the card (the backward kernels at those head dims) and on the
    CPU (plain versions) from the same parameters agree at 1e-3 * (1 + |w|),
    chip_smoke.py's limit for this check (cuBLAS and the CPU's BLAS sum
    width-2048/3840 products in different orders, and Adam's first steps
    move each parameter by about lr whatever the gradient's size)."""
    from repro_torch import tree as TR
    from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches
    from repro_torch.models import transformer as T

    cfg = get_config(arch).replace(num_layers=2, dtype="float32")
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tcfg = TrainConfig(global_batch=1, microbatch=1, seq_len=128, steps=2,
                       eval_every=2, fuse_window=1, seed=0,
                       optimizer=OptimizerConfig(total_steps=2),
                       recovery=RecoveryConfig(strategy="checkfree",
                                               num_stages=2,
                                               protect_edge_stages=False))
    result = {}
    for device in ("cuda", "cpu"):
        before = (FA.launches_dq, FA.launches_dkv)
        trainer = Trainer(Model(cfg, device=device, weights=False), tcfg)
        state, hist = trainer.run(make_batches(cfg, batch=1, seq=128, seed=0),
                                  params=TR.clone(params))
        launched = (FA.launches_dq - before[0], FA.launches_dkv - before[1])
        assert launched == ((4, 4) if device == "cuda" else (0, 0))
        result[device] = (hist.loss, TR.map(lambda t: t.detach().cpu(),
                                            state.params))
        del trainer, state
    (card_loss, card_p), (cpu_loss, cpu_p) = result["cuda"], result["cpu"]
    assert all(np.isfinite(card_loss))
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-3, atol=1e-3)
    for a, b in zip(TR.leaves(card_p), TR.leaves(cpu_p)):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# the SSD scan and the ssm / hybrid models (serving slice)
# ---------------------------------------------------------------------------

SSD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
# the backward: the flash backward's tolerances (PERF.md section 2)
SSD_GRAD_TOL = GRAD_TOL


def ssd_inputs(seed, b, t, h, p, g, n, dtype, *, real, init=False, offset=8):
    """Model layout, drawn with numpy.  ``real``: the decay of a mamba2
    layer, a = dt * A with dt = softplus(N(0, 1) + dt_bias) and A down to
    -16 (a reaches about -1.6 a token), and B and C strided views of one
    xBC tensor, starting ``offset`` elements into each row; otherwise
    tests/test_kernels.py's draws."""
    rng = np.random.default_rng(seed)

    def cuda(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    if real:
        dt0 = np.exp(rng.random(h) * (np.log(1e-1) - np.log(1e-3))
                     + np.log(1e-3))
        dt_bias = dt0 + np.log(-np.expm1(-dt0))
        dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) + dt_bias))
        a = cuda(dt * -np.linspace(1.0, 16.0, h))
        xb = cuda(rng.standard_normal((b, t, h, p)) * dt[..., None], dtype)
        xbc = cuda(rng.standard_normal((b, t, 2 * g * n + offset)), dtype)
        bm = xbc[..., offset:offset + g * n].reshape(b, t, g, n)
        cm = xbc[..., offset + g * n:].reshape(b, t, g, n)
    else:
        a = cuda(-0.1 * np.abs(rng.standard_normal((b, t, h))))
        xb = cuda(0.5 * rng.standard_normal((b, t, h, p)), dtype)
        bm = cuda(0.4 * rng.standard_normal((b, t, g, n)), dtype)
        cm = cuda(0.4 * rng.standard_normal((b, t, g, n)), dtype)
    init_state = cuda(0.5 * rng.standard_normal((b, h, p, n))) if init \
        else None
    return xb, a, bm, cm, init_state


def check_ssd(xb, a, bm, cm, init_state, chunk):
    before = SSD.launches
    y, state = SSD.ssd_scan(xb, a, bm, cm, chunk=chunk, init_state=init_state)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    assert y.dtype == xb.dtype and state.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    wy, ws = ref.ssd_chunked(xb, a, bm, cm, chunk, init_state)
    ty, ts = ref.ssd_scan_ref(*(v.transpose(1, 2) for v in (xb, a, bm, cm)),
                              init_state)
    for want_y, want_state in ((wy, ws), (ty.transpose(1, 2), ts)):
        torch.testing.assert_close(y.float(), want_y.float(),
                                   **SSD_TOL[xb.dtype])
        torch.testing.assert_close(state, want_state, **STATE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,chunk", [(64, 16), (128, 32), (128, 64)])
@pytest.mark.parametrize("h,g", [(2, 1), (4, 2)])
def test_ssd_kernel_matches_plain_sweep(dtype, t, chunk, h, g):
    check_ssd(*ssd_inputs(0, 2, t, h, 16, g, 8, dtype, real=False), chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,chunk", [(509, 64), (37, 1), (100, 48)])
@pytest.mark.parametrize("p,n", [(32, 16), (64, 128)])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_kernel_ragged_wide_real_decay(dtype, t, chunk, p, n, init):
    """Ragged last chunks, a prime prompt's chunk of 1, a starting state and
    the real decay range, where exp(cs_i - cs_j) above the diagonal is inf."""
    check_ssd(*ssd_inputs(1, 2, t, 4, p, 2, n, dtype, real=True, init=init),
              chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128, 64])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_kernel_bf16_serving_widths(n, init):
    """mamba2-1.3b's (N 128) and zamba2-2.7b's (N 64) layer cut in batch and
    heads: P 64, chunk 64, T 512, the real decay, B and C strided views of
    xBC; with and without a starting state."""
    check_ssd(*ssd_inputs(4, 2, 512, 4, 64, 1, n, torch.bfloat16, real=True,
                          init=init), 64)


@pytest.mark.gpu
@pytest.mark.parametrize("p,n", [(48, 64), (20, 128), (32, 36)])
def test_ssd_kernel_bf16_padded_p_and_n(p, n):
    """P not a multiple of the block height of 32 (48, 20) and N not a
    multiple of the tile (36): the block pads them with zeros and writes only
    what is there."""
    check_ssd(*ssd_inputs(5, 2, 200, 4, p, 2, n, torch.bfloat16, real=True,
                          init=True), 64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,chunk", [(37, 1), (301, 48), (130, 48)])
def test_ssd_kernel_small_and_ragged_chunks(dtype, t, chunk):
    """A chunk of 1 (a prime prompt) and of 48, with a ragged last chunk."""
    check_ssd(*ssd_inputs(6, 2, t, 4, 64, 1, 128, dtype, real=True,
                          init=True), chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [4, 2, 1])
@pytest.mark.parametrize("n", [128, 36])
def test_ssd_kernel_bf16_unaligned_views(offset, n):
    """B and C rows that do not start on a 16-byte boundary (8, 4 and 2
    bytes in): the block copies them in narrower pieces, the wrapper copies
    nothing."""
    xb, a, bm, cm, init = ssd_inputs(7, 2, 150, 4, 64, 1, n, torch.bfloat16,
                                     real=True, offset=offset)
    assert bm.data_ptr() % 16 and cm.stride(1) == 2 * n + offset
    check_ssd(xb, a, bm, cm, init, 64)


@pytest.mark.gpu
def test_ssd_bf16_prefill_launches_once_a_layer():
    """A reduced mamba2 prefill in bf16: one SSD launch a layer, and logits
    within 5% of the largest |logit| of the same prefill with the chunked
    plain version in the kernel's place (tests/test_smoke_archs.py's bf16
    limit)."""
    cfg = reduced(get_config("mamba2-1.3b")).replace(dtype="bfloat16")
    model = Model(cfg, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(2, 128)).astype(np.int32)).cuda()
    before = SSD.launches
    logits, _ = model.prefill({"tokens": toks}, 132)
    assert SSD.launches == before + cfg.num_layers
    kernel = SSD.ssd_scan
    try:
        SSD.ssd_scan = lambda xb, a, bm, cm, *, chunk, init_state=None: \
            ref.ssd_chunked(xb, a, bm, cm, chunk, init_state)
        want, _ = model.prefill({"tokens": toks}, 132)
    finally:
        SSD.ssd_scan = kernel
    logits, want = logits.float(), want.float()
    assert torch.isfinite(logits).all()
    assert float((logits - want).abs().max()) <= 0.05 * float(want.abs().max())


@pytest.mark.gpu
def test_ssd_kernel_carries_its_state():
    xb, a, bm, cm, _ = ssd_inputs(2, 1, 64, 1, 8, 1, 4, torch.float32,
                                  real=False)
    full, state = SSD.ssd_scan(xb, a, bm, cm, chunk=16)
    parts = [SSD.ssd_scan(xb[:, i:i + 16], a[:, i:i + 16], bm[:, i:i + 16],
                          cm[:, i:i + 16], chunk=16)[0] for i in range(0, 64, 16)]
    assert float((full - torch.cat(parts, dim=1)).abs().max()) > 1e-3
    y1, s1 = SSD.ssd_scan(xb[:, :32], a[:, :32], bm[:, :32], cm[:, :32],
                          chunk=16)
    y2, s2 = SSD.ssd_scan(xb[:, 32:], a[:, 32:], bm[:, 32:], cm[:, 32:],
                          chunk=16, init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), full,
                               **SSD_TOL[torch.float32])
    torch.testing.assert_close(s2, state, **STATE_TOL)


@pytest.mark.gpu
def test_ops_ssd_scan_refuses_a_gradient_on_the_card():
    """It refused until the scan had a backward kernel; now an input that
    requires a gradient goes through ``SSD.SSDScan``: the forward kernel
    once, the backward kernel once, and the gradients of the plain version.
    Without grad mode the forward kernel runs alone."""
    xb, a, bm, cm, _ = ssd_inputs(3, 1, 32, 2, 8, 1, 4, torch.float32,
                                  real=False)
    xb.requires_grad_()
    fwd, bwd = SSD.launches, SSD.launches_bwd
    y, _ = ops.ssd_scan(xb, a, bm, cm, chunk=16)
    assert y.grad_fn is not None
    y.square().sum().backward()
    assert (SSD.launches - fwd, SSD.launches_bwd - bwd) == (1, 1)
    want = ref.ssd_chunked_bwd_ref(xb.detach(), a, bm, cm, 16, None,
                                   2 * y.detach(), None)[0]
    torch.testing.assert_close(xb.grad, want, **SSD_GRAD_TOL[torch.float32])
    with torch.no_grad():
        y, _ = ops.ssd_scan(xb, a, bm, cm, chunk=16)
    assert SSD.launches_bwd - bwd == 1
    want, _ = ref.ssd_chunked(xb.detach(), a, bm, cm, 16)
    torch.testing.assert_close(y, want, **SSD_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kw", [("mamba2-1.3b", {}),
                                     ("zamba2-2.7b", dict(num_layers=4,
                                                          attn_every=2))])
@pytest.mark.parametrize("s", [37, 64])
def test_ssm_models_on_card_match_cpu(arch, kw, s):
    cfg = reduced(get_config(arch)).replace(dtype="float32", **kw)
    params = Model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0)).params
    cpu = Model(cfg, params, device="cpu")
    card = Model(cfg, params, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, s)).astype(np.int32))
    ssd_before, fa_before = SSD.launches, FA.launches
    logits, cache = card.prefill({"tokens": toks.cuda()}, s + 4)
    assert SSD.launches == ssd_before + cfg.num_layers
    segments = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    assert FA.launches == fa_before + segments
    want, want_cache = cpu.prefill({"tokens": toks}, s + 4)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
    for key in want_cache:
        torch.testing.assert_close(cache[key].cpu(), want_cache[key],
                                   atol=1e-4, rtol=1e-4)
    nxt = want[:, -1].argmax(-1).to(torch.int32)
    for _ in range(2):
        logits, cache = card.decode_step(cache, nxt.cuda())
        want, want_cache = cpu.decode_step(want_cache, nxt)
        torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
        nxt = want[:, -1].argmax(-1).to(torch.int32)


@pytest.mark.gpu
def test_checkpoint_trainer_on_card_matches_cpu(tmp_path):
    """2 reduced layers, 2 stages, fp32: ``checkpoint`` on the card and on
    the CPU through a restart before the first save (wall 1) and a rollback
    (wall 5, from step 4 to the save at 3): the same trace, losses within
    1e-4, each replayed step equal to its first run on the card."""
    from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches

    class Forced:
        def at(self, step):
            return {1: [1], 5: [0]}.get(step, [])

    cfg = get_config("paper-llama-124m").replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=344,
        vocab_size=512, max_seq_len=64, dtype="float32")
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    hists = {}
    for device in ("cuda", "cpu"):
        tcfg = TrainConfig(
            global_batch=4, microbatch=4, seq_len=64, steps=6, fuse_window=1,
            optimizer=OptimizerConfig(lr=6e-4, total_steps=6),
            recovery=RecoveryConfig(strategy="checkpoint", num_stages=2,
                                    checkpoint_every=3,
                                    checkpoint_dir=str(tmp_path / device)))
        trainer = Trainer(Model(cfg, device=device, weights=False), tcfg,
                          schedule=Forced())
        _, hists[device] = trainer.run(make_batches(cfg, batch=4, seq=64),
                                       params=params)
    card, cpu = hists["cuda"], hists["cpu"]
    assert card.steps == cpu.steps == [1, 1, 2, 3, 4, 4, 5, 6]
    assert card.failures == cpu.failures
    np.testing.assert_allclose(card.loss, cpu.loss, rtol=1e-4)
    assert card.loss[1] == card.loss[0] and card.loss[5] == card.loss[4]


@pytest.mark.gpu
def test_host_snapshot_from_the_card_is_bit_equal_and_pinned():
    from repro_torch import tree as TR
    from repro_torch.optim.adam import OptState
    from repro_torch.statestore import host_snapshot, snapshot_to_tree

    gen = torch.Generator("cuda").manual_seed(0)
    params = {"w": torch.randn(64, 33, generator=gen, device="cuda"),
              "b": torch.randn(130, generator=gen, device="cuda").bfloat16(),
              "i": torch.arange(7, dtype=torch.int32, device="cuda")}
    tree = (params, OptState(TR.map(torch.zeros_like, params),
                             TR.map(torch.ones_like, params), 3))
    want = [t.cpu() for t in TR.flatten(tree)[0][:-1]]
    snap = host_snapshot(tree, step=3, shard_id="full")
    for got, ref in zip(snap.leaves[:-1], want):
        assert got.device.type == "cpu" and got.is_pinned()
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    params["w"].add_(1.0)          # the card's state moves on in place
    assert torch.equal(snap.leaves[2], want[2])
    assert snapshot_to_tree(snap, tree)[1].step == 3


@pytest.mark.gpu
def test_restore_into_live_card_leaves_keeps_identity():
    from repro_torch.statestore import copy_into, host_snapshot
    from repro_torch.statestore import snapshot_to_tree

    gen = torch.Generator("cuda").manual_seed(0)
    live = {"w": torch.randn(8, 8, device="cuda",
                             generator=gen).requires_grad_()}
    saved = snapshot_to_tree(host_snapshot(live, step=1, shard_id="full"),
                             live)
    w = live["w"]
    before = w.detach().clone()
    with torch.no_grad():
        w.mul_(3.0)
    out = copy_into(live, saved)
    assert out["w"] is w and w.is_cuda and w.requires_grad
    assert torch.equal(w.detach(), before)


# ---------------------------------------------------------------------------
# Adam in two kernels, and fused training windows as CUDA graphs
# ---------------------------------------------------------------------------

def adam_leaves(seed, layers=3, offset=0):
    """A tree's worth of fp32 leaves on the card: tower leaves (layers along
    axis 0, rows of 1 to 3 chunks of the sum-of-squares pass, a tail not a
    multiple of 4) and two others; ``offset`` elements into a larger buffer
    moves every leaf off its 16-byte boundary."""
    rng = np.random.default_rng(seed)
    shapes = [(layers, 16384), (layers, 5, 7), (layers, 33000), (layers, 96),
              (1000, 24), (13,)]
    tower = [True, True, True, True, False, False]
    leaves = []
    for sh in shapes:
        n = int(np.prod(sh))
        buf = torch.from_numpy(rng.standard_normal(n + offset)
                               .astype(np.float32)).cuda()
        leaves.append(buf[offset:].view(sh))
    return leaves, tower


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_adam_sumsq_kernel_matches_plain(offset):
    """Per-layer sums and the total against the plain version (and so
    against global_norm and stage_grad_sqnorms), 1e-6 relative: the kernel
    sums in fp64, the plain version in fp32."""
    from repro_torch.kernels import adam as AD
    leaves, tower = adam_leaves(offset, offset=offset)
    before = AD.launches_sumsq
    per_layer, total = AD.adam_sumsq(leaves, tower, 3)
    torch.cuda.synchronize()
    assert AD.launches_sumsq == before + 1
    want_layer, want_total = ref.adam_sumsq_ref(leaves, tower, 3)
    torch.testing.assert_close(per_layer, want_layer, rtol=1e-6, atol=0)
    torch.testing.assert_close(total, want_total, rtol=1e-6, atol=0)
    # the same as the trainer's plain norms of a tree with this tower
    from repro_torch.core.stages import StagePartition
    from repro_torch.optim.adam import global_norm
    grads = {"blocks": {f"w{i}": g for i, g in enumerate(leaves[:4])},
             "embed": {"table": leaves[4]}, "final_norm": {"scale": leaves[5]}}
    part = StagePartition(get_config("paper-llama-124m").replace(num_layers=3),
                          3)
    torch.testing.assert_close(total.sqrt(), global_norm(grads), rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(part.stage_sums(per_layer),
                               part.stage_grad_sqnorms(grads), rtol=1e-6,
                               atol=0)
    again = AD.adam_sumsq(leaves, tower, 3)
    assert torch.equal(again[0], per_layer) and torch.equal(again[1], total)


@pytest.mark.gpu
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("grad_scale", [1.0, 100.0])
@pytest.mark.parametrize("offset", [0, 1])
def test_adam_update_kernel_matches_plain(weight_decay, grad_scale, offset):
    """p, m and v against the plain version on the same inputs within
    1e-6 * (1 + |w|), with weight decay and with a clip that bites; two
    runs give the same bits."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.kernels import adam as AD
    from repro_torch.optim import adam as A
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                          weight_decay=weight_decay)
    params, _ = adam_leaves(10 + offset, offset=offset)
    grads = [g * grad_scale for g in adam_leaves(20 + offset,
                                                 offset=offset)[0]]
    m = [0.1 * t for t in adam_leaves(30, offset=offset)[0]]
    v = [0.01 * t.abs() for t in adam_leaves(40, offset=offset)[0]]
    gn = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    scalars = A.adam_scalars(cfg, torch.tensor(5, device="cuda"),
                             torch.tensor(1.1, device="cuda"), gn)
    if grad_scale > 1:
        assert float(scalars[0]) < 1.0               # the clip bites
    opts = A.update_options(cfg)
    runs = []
    for _ in range(2):
        p, mm, vv = ([t.clone() for t in ts] for ts in (params, m, v))
        before = AD.launches_update
        AD.adam_update(p, grads, mm, vv, scalars, **opts)
        torch.cuda.synchronize()
        assert AD.launches_update == before + 1
        runs.append((p, mm, vv))
    p, mm, vv = ([t.clone() for t in ts] for ts in (params, m, v))
    ref.adam_update_ref(p, grads, mm, vv, scalars, **opts)
    for got, again, want in zip(runs[0], runs[1], (p, mm, vv)):
        for a, b, w in zip(got, again, want):
            assert torch.equal(a, b)
            assert bool(((a - w).abs() <= 1e-6 * (1 + w.abs())).all())


def fused_config(window, steps=10, strategy="checkfree_plus"):
    from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
    return TrainConfig(global_batch=4, microbatch=4, seq_len=64, steps=steps,
                       eval_every=100, fuse_window=window,
                       optimizer=OptimizerConfig(lr=6e-4, total_steps=steps),
                       recovery=RecoveryConfig(strategy=strategy,
                                               num_stages=2,
                                               protect_edge_stages=False))


class FusedForced:
    def at(self, step):
        return {5: [1]}.get(step, [])


def fused_run(device, window, params, setup=None):
    from repro_torch import tree as TR
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches
    cfg = get_config("paper-llama-124m").replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=344,
        vocab_size=512, max_seq_len=64, dtype="float32")
    trainer = Trainer(Model(cfg, device=device, weights=False),
                      fused_config(window), schedule=FusedForced())
    if setup is not None:
        setup(trainer)
    state, hist = trainer.run(make_batches(cfg, batch=4, seq=64),
                              params=TR.clone(params))
    return trainer, TR.map(lambda t: t.detach().cpu(), state.params), hist


def fused_params():
    cfg = get_config("paper-llama-124m").replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=344,
        vocab_size=512, max_seq_len=64, dtype="float32")
    return Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))


@pytest.mark.gpu
def test_fused_run_on_card_matches_cpu():
    """2 layers, ``checkfree_plus``, windows of up to 8 cut by a merge at
    wall 5: the graph replays on the card against the same windows on the
    CPU, losses and parameters within 1e-3 * (1 + |w|) (chip_smoke.py's
    TRAIN_MODEL_TOL: cuBLAS and the CPU sum in other orders); every replay
    ran its recorded Adam launches."""
    from repro_torch import tree as TR
    params = fused_params()
    card_trainer, card_p, card = fused_run("cuda", 8, params)
    _, cpu_p, cpu = fused_run("cpu", 8, params)
    assert card.steps == cpu.steps and card.failures == cpu.failures == [(5, 1)]
    assert card.dispatches == cpu.dispatches < card.wall_iters
    np.testing.assert_allclose(card.loss, cpu.loss, rtol=1e-3, atol=1e-3)
    for a, b in zip(TR.leaves(card_p), TR.leaves(cpu_p)):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    window = card_trainer.window
    assert window.captures == 1 and window.replays == 10 - 1
    assert window.recorded_launches["adam_sumsq"] == 1
    assert window.recorded_launches["adam_update"] == 1
    assert window.recorded_launches["flash_attention_fwd"] == 4


@pytest.mark.gpu
def test_graph_replay_matches_eager_steps_on_card():
    """The same run in windows of 8 (graph replays) and of 1 (eager steps)
    on the card: the same kernels on the same inputs, within 1e-5
    relative."""
    from repro_torch import tree as TR
    params = fused_params()
    _, p8, h8 = fused_run("cuda", 8, params)
    _, p1, h1 = fused_run("cuda", 1, params)
    assert h8.steps == h1.steps and h8.failures == h1.failures
    np.testing.assert_allclose(h8.loss, h1.loss, rtol=1e-5)
    np.testing.assert_allclose([e for _, e in h8.recovery_errors],
                               [e for _, e in h1.recovery_errors], rtol=1e-5)
    for a, b in zip(TR.leaves(p8), TR.leaves(p1)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_window_runs_under_sync_debug_error():
    """Every replay runs with ``set_sync_debug_mode("error")``; a host read
    inside the window raises there, and the mode is restored after."""
    modes = []
    replay = torch.cuda.CUDAGraph.replay

    def recording(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        return replay(self)

    torch.cuda.CUDAGraph.replay = recording
    try:
        fused_run("cuda", 8, fused_params())
    finally:
        torch.cuda.CUDAGraph.replay = replay
    assert len(modes) == 9 and set(modes) == {2}     # 2: "error"
    assert torch.cuda.get_sync_debug_mode() == 0

    def reading(trainer):
        body = trainer.window.body

        def read_back(*args):
            rec = body(*args)
            rec[0].item()                             # a host read
            return rec

        trainer.window.body = read_back

    with pytest.raises(RuntimeError, match="synchroniz"):
        fused_run("cuda", 8, fused_params(), setup=reading)
    assert torch.cuda.get_sync_debug_mode() == 0


# ---------------------------------------------------------------------------
# elastic re-layouts on the card: a new window, a new capture, the old pool
# back to the device
# ---------------------------------------------------------------------------

class ElasticForced:
    """6 layers on 4 stages (2, 2, 1, 1): slot 2 fails at wall 3 (its
    neighbours hold 2 and 1 layers), slot 1 departs at wall 6 (4 -> 3
    stages), regrows at 10 (3 -> 4), slot 2 departs at 14 (4 -> 3)."""
    fails = {3: [2], 6: [1], 14: [2]}
    departs = {6: [1], 14: [2]}
    regrows = {10: [1]}

    def at(self, step):
        return list(self.fails.get(step, []))

    def departed_at(self, step):
        return list(self.departs.get(step, []))

    def regrown_at(self, step):
        return list(self.regrows.get(step, []))


def elastic_cfg():
    return get_config("paper-llama-124m").replace(
        num_layers=6, d_model=128, num_heads=4, num_kv_heads=4, d_ff=344,
        vocab_size=512, max_seq_len=64, dtype="float32")


def elastic_run(device, params, window=8):
    from repro_torch import tree as TR
    from repro_torch.config import (OptimizerConfig, RecoveryConfig,
                                    TrainConfig)
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches
    tcfg = TrainConfig(global_batch=4, microbatch=4, seq_len=64, steps=20,
                       eval_every=100, fuse_window=window,
                       optimizer=OptimizerConfig(lr=6e-4, total_steps=20),
                       recovery=RecoveryConfig(strategy="elastic",
                                               num_stages=4))
    trainer = Trainer(Model(elastic_cfg(), device=device, weights=False),
                      tcfg, schedule=ElasticForced())
    state, hist = trainer.run(make_batches(elastic_cfg(), batch=4, seq=64),
                              params=TR.clone(params))
    return trainer, TR.map(lambda t: t.detach().cpu(), state.params), hist


def elastic_params():
    return Model(elastic_cfg(), device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))


@pytest.mark.gpu
def test_elastic_shrink_and_grow_on_card_matches_cpu():
    """``elastic`` in windows of 8 through a shrink, a grow and a shrink on
    the card against the same run on the CPU: the same re-layouts,
    failures and windows, losses and parameters within 1e-3 * (1 + |w|)."""
    from repro_torch import tree as TR
    params = elastic_params()
    card_trainer, card_p, card = elastic_run("cuda", params)
    cpu_trainer, cpu_p, cpu = elastic_run("cpu", params)
    assert card_trainer.repartition_log == cpu_trainer.repartition_log
    assert [r[1:4] for r in card_trainer.repartition_log] == [
        ("shrink", 4, 3), ("grow", 3, 4), ("shrink", 4, 3)]
    assert card.steps == cpu.steps and card.failures == cpu.failures
    assert card.dispatches == cpu.dispatches < card.wall_iters
    np.testing.assert_allclose(card.loss, cpu.loss, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose([e for _, e in card.recovery_errors],
                               [e for _, e in cpu.recovery_errors],
                               rtol=1e-3, atol=1e-3)
    for a, b in zip(TR.leaves(card_p), TR.leaves(cpu_p)):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_elastic_recaptures_once_per_layout_with_the_new_omegas():
    """One capture per layout epoch; every ring of an epoch is OMEGAS + K
    wide for that epoch's K; the losses equal the eager run's at 1e-5."""
    from repro_torch.core.window import OMEGAS, FusedWindow
    rings, windows = [], []
    drain, init = FusedWindow.drain, FusedWindow.__init__

    def recording(self, pending):
        state, ring = drain(self, pending)
        rings.append((self.part.num_stages, ring))
        return state, ring

    def made(self, *args, **kw):
        init(self, *args, **kw)
        windows.append(self)

    FusedWindow.drain, FusedWindow.__init__ = recording, made
    try:
        trainer, _, hist = elastic_run("cuda", elastic_params())
    finally:
        FusedWindow.drain, FusedWindow.__init__ = drain, init
    _, _, eager = elastic_run("cuda", elastic_params(), window=1)
    assert [w.captures for w in windows] == [1, 1, 1, 1]
    assert [w.part.num_stages for w in windows] == [4, 3, 4, 3]
    assert trainer.window is windows[-1]
    assert all(w.graph is None for w in windows[:-1])
    assert all(ring.shape[1] == OMEGAS + k for k, ring in rings)
    np.testing.assert_allclose(hist.loss, eager.loss, rtol=1e-5)


@pytest.mark.gpu
def test_elastic_relayouts_give_the_old_pool_back():
    """Reserved memory after each re-capture stays within one graph pool of
    its value after the first: a pool leaked per re-layout would add one
    pool each time."""
    from repro_torch.core.window import FusedWindow
    reserved = []
    capture = FusedWindow._capture

    def measured(self, batch):
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved()
        capture(self, batch)
        torch.cuda.synchronize()
        reserved.append((before, torch.cuda.memory_reserved()))

    torch.cuda.empty_cache()
    FusedWindow._capture = measured
    try:
        elastic_run("cuda", elastic_params())
    finally:
        FusedWindow._capture = capture
    assert len(reserved) == 4
    pool = reserved[0][1] - reserved[0][0]
    assert pool > 0
    assert all(after - reserved[0][1] < pool for _, after in reserved[1:])


# ---------------------------------------------------------------------------
# the SSD backward kernel and ssm / hybrid training
# ---------------------------------------------------------------------------

def ssd_bwd_case(seed, b, t, h, p, g, n, dtype, *, real, init=False,
                 dfinal=False, offset=8):
    """The forward's inputs (``ssd_inputs``) and numpy-drawn dy and dfinal."""
    xb, a, bm, cm, init_state = ssd_inputs(seed, b, t, h, p, g, n, dtype,
                                           real=real, init=init,
                                           offset=offset)
    rng = np.random.default_rng(seed + 1000)
    dy = torch.from_numpy(rng.standard_normal((b, t, h, p)).astype(
        np.float32)).to("cuda", dtype)
    df = torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(
        np.float32)).cuda() if dfinal else None
    return xb, a, bm, cm, init_state, dy, df


def check_ssd_bwd(xb, a, bm, cm, init_state, dy, df, chunk):
    """The backward kernel against ``ssd_chunked_bwd_ref`` on the same
    inputs: each gradient within the tolerance, finite, in its dtype; a
    second launch gives the same bits."""
    before = SSD.launches_bwd
    got = SSD.ssd_scan_bwd(xb, a, bm, cm, dy, chunk=chunk,
                           init_state=init_state, dfinal=df)
    again = SSD.ssd_scan_bwd(xb, a, bm, cm, dy, chunk=chunk,
                             init_state=init_state, dfinal=df)
    torch.cuda.synchronize()
    assert SSD.launches_bwd == before + 2
    want = ref.ssd_chunked_bwd_ref(xb, a, bm, cm, chunk, init_state, dy, df)
    for name, g1, g2, w in zip(("dx", "da", "db", "dc", "dinit"), got, again,
                               want):
        if init_state is None and name == "dinit":
            assert g1 is None
            continue
        assert g1.dtype == w.dtype, name
        assert torch.isfinite(g1.float()).all(), name
        assert torch.equal(g1, g2), name
        torch.testing.assert_close(g1.float(), w.float(),
                                   **SSD_GRAD_TOL[xb.dtype], msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,chunk", [(64, 16), (128, 32), (128, 64)])
@pytest.mark.parametrize("h,g", [(2, 1), (4, 2)])
def test_ssd_bwd_kernel_matches_plain_sweep(dtype, t, chunk, h, g):
    """tests/test_kernels.py's SSD shapes (B 2, P 16, N 8), with dfinal."""
    check_ssd_bwd(*ssd_bwd_case(10, 2, t, h, 16, g, 8, dtype, real=False,
                                dfinal=True), chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,chunk", [(509, 64), (37, 1), (100, 48), (23, 7)])
@pytest.mark.parametrize("p,n", [(32, 16), (64, 128), (20, 36)])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_bwd_kernel_ragged_wide_real_decay(dtype, t, chunk, p, n, init):
    """Ragged last chunks, a chunk of 1, the widest P and N, the real decay
    range (exp(cs_i - cs_j) above the diagonal overflows), B and C strided
    views of xBC, a starting state and dfinal: finite gradients equal to the
    plain version's."""
    check_ssd_bwd(*ssd_bwd_case(11, 2, t, 4, p, 2, n, dtype, real=True,
                                init=init, dfinal=init), chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h", [(128, 4), (64, 5)])
def test_ssd_bwd_kernel_bf16_training_widths(n, h):
    """mamba2-1.3b's (N 128) and zamba2-2.7b's (N 64) layer cut in batch and
    heads: P 64, chunk 64, T 512, the real decay, one group."""
    check_ssd_bwd(*ssd_bwd_case(12, 2, 512, h, 64, 1, n, torch.bfloat16,
                                real=True), 64)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [4, 1])
def test_ssd_bwd_kernel_unaligned_views(offset):
    xb, a, bm, cm, init, dy, df = ssd_bwd_case(13, 2, 150, 4, 64, 1, 36,
                                               torch.bfloat16, real=True,
                                               offset=offset)
    assert bm.data_ptr() % 16
    check_ssd_bwd(xb, a, bm, cm, init, dy.transpose(0, 1).contiguous()
                  .transpose(0, 1), df, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [20, 48])
@pytest.mark.parametrize("n", [128, 36])
def test_ssd_bwd_kernel_p_not_a_multiple_of_the_block(p, n):
    """P 20 and 48, not multiples of the bf16 kernel's 32 state rows a
    block (one padded block, or a full one beside a padded one), at N 128
    and 36, with the real decay, a starting state and dfinal."""
    check_ssd_bwd(*ssd_bwd_case(17, 2, 300, 4, p, 2, n, torch.bfloat16,
                                real=True, init=True, dfinal=True), 64)


@pytest.mark.gpu
def test_ssd_bwd_kernel_mamba2_full_head_count():
    """mamba2-1.3b's layer cut only in batch: B 1, 64 heads of P 64 (two P
    blocks a head, whose dB, dC and d cs parts are summed in order over the
    blocks, then over the 64 heads of the one group), N 128, T 512."""
    check_ssd_bwd(*ssd_bwd_case(18, 1, 512, 64, 64, 1, 128, torch.bfloat16,
                                real=True), 64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_bwd_runs_the_walk_kernel_of_its_dtype(dtype):
    """A bf16 call runs the tensor-core walk and never the fp32 one, and an
    fp32 call the reverse: by the wrapper's count of each path and by the
    names of the kernels the profiler records on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    xb, a, bm, cm, _, dy, _ = ssd_bwd_case(19, 1, 128, 2, 64, 1, 128, dtype,
                                           real=True)
    SSD.ssd_scan_bwd(xb, a, bm, cm, dy, chunk=64)     # built before the trace
    torch.cuda.synchronize()
    want, other = (("bf16", "f32") if dtype == torch.bfloat16
                   else ("f32", "bf16"))
    before = dict(SSD.launches_bwd_path)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        SSD.ssd_scan_bwd(xb, a, bm, cm, dy, chunk=64)
        torch.cuda.synchronize()
    assert SSD.launches_bwd_path[want] == before[want] + 1
    assert SSD.launches_bwd_path[other] == before[other]
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    assert any(f"ssd_bwd_{want}_kernel" in n for n in names), names
    assert not any(f"ssd_bwd_{other}_kernel" in n for n in names), names
    assert any("ssd_bwd_sum_kernel" in n for n in names), names


@pytest.mark.gpu
def test_ssd_bwd_kernel_refuses_what_it_was_not_built_for():
    xb, a, bm, cm, _, dy, _ = ssd_bwd_case(14, 1, 32, 2, 8, 1, 8,
                                           torch.float32, real=False)
    before = SSD.launches_bwd
    with pytest.raises(NotImplementedError, match="P=6"):
        SSD.ssd_scan_bwd(xb[..., :6], a, bm, cm, dy[..., :6], chunk=16)
    with pytest.raises(ValueError, match="chunk=65"):
        SSD.ssd_scan_bwd(xb, a, bm, cm, dy, chunk=65)
    with pytest.raises(ValueError, match="dy must be"):
        SSD.ssd_scan_bwd(xb, a, bm, cm, dy.bfloat16(), chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_scan_bwd(xb.cpu(), a, bm, cm, dy, chunk=16)
    assert SSD.launches_bwd == before


@pytest.mark.gpu
def test_ssd_bwd_kernel_captures_and_replays_in_a_cuda_graph():
    """Captured once and replayed on new inputs copied into the static
    ones, the backward gives the bits of an eager launch on those inputs."""
    xb, a, bm, cm, init, dy, df = ssd_bwd_case(15, 2, 200, 4, 64, 1, 128,
                                               torch.bfloat16, real=True,
                                               init=True, dfinal=True)
    static = [xb.clone(), a.clone(), bm.clone(), cm.clone(), init.clone(),
              dy.clone(), df.clone()]

    def run():
        x_, a_, b_, c_, i_, dy_, df_ = static
        return SSD.ssd_scan_bwd(x_, a_, b_, c_, dy_, chunk=64, init_state=i_,
                                dfinal=df_)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()                                   # warm-up: builds the library
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    new = ssd_bwd_case(16, 2, 200, 4, 64, 1, 128, torch.bfloat16, real=True,
                       init=True, dfinal=True)
    for dst, src in zip(static, new):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    want = SSD.ssd_scan_bwd(*new[:4], new[5], chunk=64, init_state=new[4],
                            dfinal=new[6])
    for got, w in zip(out, want):
        assert torch.equal(got, w)


@pytest.mark.gpu
def test_ssm_layer_gradients_through_the_kernels_match_plain(monkeypatch):
    """One bf16 mamba2 block at zamba2's widths cut in heads: the gradients
    of every parameter through ``SSDScan`` (both kernels) against the same
    block with the plain ``ssd_chunked`` and PyTorch's autograd, on the
    card."""
    from repro_torch import tree as TR
    from repro_torch.models import ssm as S
    cfg = get_config("zamba2-2.7b").replace(d_model=256, dtype="bfloat16")
    bp = S.init_mamba_block(torch.Generator("cuda").manual_seed(0), cfg,
                            torch.bfloat16, "cuda", 1)
    bp = TR.map(lambda t: t[0].float().requires_grad_(), bp)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (2, 160, 256)).astype(np.float32)).to("cuda", torch.bfloat16)
    grads = {}
    for name in ("kernel", "plain"):
        if name == "plain":
            monkeypatch.setattr(
                ops, "ssd_scan", lambda xb, a, b_, c_, *, chunk,
                init_state=None: ref.ssd_chunked(xb, a, b_, c_, chunk,
                                                 init_state))
        before = SSD.launches_bwd
        out = S.mamba_block(TR.map(lambda t: t.bfloat16(), bp), x, cfg)
        grads[name] = torch.autograd.grad(out.float().square().mean(),
                                          TR.leaves(bp))
        assert SSD.launches_bwd - before == (name == "kernel")
    for g, w in zip(grads["kernel"], grads["plain"]):
        assert torch.isfinite(g).all()
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 3e-2 * (1 + scale)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
@pytest.mark.parametrize("strategy", ["checkfree", "checkfree_plus"])
def test_ssm_families_train_on_card_as_on_cpu(arch, strategy):
    """2 layers at reduced width (zamba2: the shared block after each), fp32:
    three Adam steps of the Trainer on the card (the SSD kernels, and for
    zamba2 the flash kernels at head dim 64) and on the CPU (plain versions)
    from the same parameters agree at 1e-3 * (1 + |w|); the SSD scan and its
    backward launch once a layer and half-batch."""
    from repro_torch import tree as TR
    from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches

    cfg = reduced(get_config(arch)).replace(dtype="float32")
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    tcfg = TrainConfig(global_batch=4, microbatch=4, seq_len=96, steps=3,
                       eval_every=3, fuse_window=1, seed=0,
                       optimizer=OptimizerConfig(total_steps=3),
                       recovery=RecoveryConfig(strategy=strategy,
                                               num_stages=2,
                                               protect_edge_stages=False))
    halves = 2 if strategy == "checkfree_plus" else 1
    result = {}
    for device in ("cuda", "cpu"):
        before = (SSD.launches, SSD.launches_bwd)
        trainer = Trainer(Model(cfg, device=device, weights=False), tcfg)
        state, hist = trainer.run(make_batches(cfg, batch=4, seq=96, seed=0),
                                  params=TR.clone(params))
        launched = (SSD.launches - before[0], SSD.launches_bwd - before[1])
        want = cfg.num_layers * 3 * halves
        assert launched == ((want, want) if device == "cuda" else (0, 0))
        result[device] = (hist.loss, TR.map(lambda t: t.detach().cpu(),
                                            state.params))
        del trainer, state
    (card_loss, card_p), (cpu_loss, cpu_p) = result["cuda"], result["cpu"]
    assert all(np.isfinite(card_loss))
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-3, atol=1e-3)
    for a, b in zip(TR.leaves(card_p), TR.leaves(cpu_p)):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_ssm_fused_windows_equal_eager_steps_on_card():
    """Reduced mamba2, ``checkfree_plus``: windows of 8 (a replayed CUDA
    graph holding both SSD kernels) give the eager steps' losses and
    parameters bit for bit."""
    from repro_torch import tree as TR
    from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches

    cfg = reduced(get_config("mamba2-1.3b")).replace(dtype="bfloat16")
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    runs = {}
    for window in (8, 1):
        tcfg = TrainConfig(global_batch=4, microbatch=4, seq_len=128,
                           steps=10, eval_every=100, fuse_window=window,
                           optimizer=OptimizerConfig(lr=6e-4, total_steps=10),
                           recovery=RecoveryConfig(strategy="checkfree_plus",
                                                   num_stages=2,
                                                   protect_edge_stages=False))
        trainer = Trainer(Model(cfg, device="cuda", weights=False), tcfg,
                          schedule=FusedForced())
        state, hist = trainer.run(make_batches(cfg, batch=4, seq=128),
                                  params=TR.clone(params))
        runs[window] = (hist, TR.map(lambda t: t.detach().cpu(),
                                     state.params))
        if window == 8:
            assert trainer.window.captures == 1
            assert trainer.window.recorded_launches["ssd_scan_bwd"] == 4
    (h8, p8), (h1, p1) = runs[8], runs[1]
    assert h8.failures == h1.failures == [(5, 1)]
    assert h8.loss == h1.loss
    for a, b in zip(TR.leaves(p8), TR.leaves(p1)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_capture_empties_the_cache_only_without_room(monkeypatch):
    """Where the device's free memory could not hold the graph's pool beside
    the eager step's cached blocks, the capture empties the cache first; the
    replays give the same bits either way (reduced mamba2, windows of 8)."""
    from repro_torch import tree as TR
    from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches

    cfg = reduced(get_config("mamba2-1.3b")).replace(dtype="bfloat16")
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    tcfg = TrainConfig(global_batch=4, microbatch=4, seq_len=128, steps=8,
                       eval_every=100, fuse_window=8,
                       optimizer=OptimizerConfig(lr=6e-4, total_steps=8),
                       recovery=RecoveryConfig(strategy="checkfree_plus",
                                               num_stages=2,
                                               protect_edge_stages=False))
    runs = {}
    for room in (True, False):
        if not room:
            monkeypatch.setattr(torch.cuda, "mem_get_info",
                                lambda device=None: (0, 80 * 2 ** 30))
        trainer = Trainer(Model(cfg, device="cuda", weights=False), tcfg)
        state, hist = trainer.run(make_batches(cfg, batch=4, seq=128),
                                  params=TR.clone(params))
        assert trainer.window.captures == 1
        assert trainer.window.kept_cache is room
        runs[room] = (hist.loss, TR.map(lambda t: t.detach().cpu(),
                                        state.params))
        del trainer, state          # a trainer and its window form a cycle
    assert runs[True][0] == runs[False][0]
    for a, b in zip(TR.leaves(runs[True][1]), TR.leaves(runs[False][1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# telemetry on the card: the sites add no host sync and change no bits
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def sync_warnings():
    """PyTorch's warnings of synchronizing CUDA calls inside, as a list
    (``set_sync_debug_mode("warn")``; a window's replays run under
    "error" all the same)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def syncs(seen) -> int:
    return sum("synchroniz" in str(w.message) for w in seen)


@pytest.mark.gpu
def test_lit_fused_run_on_card_equals_dark():
    """The 2-layer fused run with a recorder installed and without: the
    same loss bits, dispatches and synchronizing calls; every window a
    ``window_dispatch`` and a ``window_drain`` span."""
    from repro_torch import telemetry
    from repro_torch import tree as TR
    params = fused_params()
    fused_run("cuda", 8, params)                      # builds, warms up
    with sync_warnings() as seen:
        _, dark_p, dark = fused_run("cuda", 8, params)
    dark_syncs = syncs(seen)
    rec = telemetry.Recorder(stream=False)
    prev = telemetry.set_recorder(rec)
    try:
        with sync_warnings() as seen:
            _, lit_p, lit = fused_run("cuda", 8, params)
    finally:
        telemetry.set_recorder(prev)
    assert lit.loss == dark.loss and lit.dispatches == dark.dispatches
    assert syncs(seen) == dark_syncs
    for a, b in zip(TR.leaves(lit_p), TR.leaves(dark_p)):
        assert torch.equal(a, b)
    assert telemetry.validate_events(rec.events) == []
    names = [s["name"] for s in rec.spans]
    assert names.count("window_dispatch") == names.count(
        "window_drain") == lit.dispatches
    assert names.count("recovery") == 1


@pytest.mark.gpu
def test_store_events_from_pinned_snapshots_are_valid(tmp_path):
    """Snapshots of card tensors into pinned host memory: the memory tier's
    save on the main thread, the disk tier's on the snapshotter's, and the
    restore, each a valid event with the snapshot's own byte count."""
    from repro_torch import telemetry
    from repro_torch.core.walltime import WallClockModel
    from repro_torch.statestore import DiskTier, MemoryTier, StateStore
    specs = WallClockModel().tier_specs()
    store = StateStore([MemoryTier(specs["mem"]),
                        DiskTier(specs["disk"], str(tmp_path))])
    gen = torch.Generator("cuda").manual_seed(0)
    tree = {"w": torch.randn(64, 33, device="cuda", generator=gen),
            "b": torch.randn(130, device="cuda", generator=gen).bfloat16()}
    rec = telemetry.Recorder(stream=False)
    prev = telemetry.set_recorder(rec)
    try:
        snaps = [store.put(tree, step=1, shard_id="s0", tier="mem"),
                 store.put(tree, step=2, shard_id="s0", tier="disk")]
        store.flush()
        res = store.restore("s0", template=tree)
        store.close()
    finally:
        telemetry.set_recorder(prev)
    assert all(t.is_pinned() for snap in snaps for t in snap.leaves)
    assert telemetry.validate_events(rec.events) == []
    saves = [e for e in rec.events if e["kind"] == "snapshot_save"]
    assert [(e["tier"], e["synchronous"], e["nbytes"]) for e in saves] == [
        ("mem", True, snaps[0].nbytes), ("disk", False, snaps[1].nbytes)]
    restore, = [e for e in rec.events if e["kind"] == "snapshot_restore"]
    assert (restore["tier"], restore["nbytes"]) == ("disk", res.nbytes)


@pytest.mark.gpu
def test_recorder_installed_while_windows_replay_under_sync_error():
    """With a recorder installed, every replay still runs under
    ``set_sync_debug_mode("error")`` and nothing raises: the sites run
    around the window, never in it."""
    from repro_torch import telemetry
    modes = []
    replay = torch.cuda.CUDAGraph.replay

    def recording(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        return replay(self)

    rec = telemetry.Recorder(stream=False)
    prev = telemetry.set_recorder(rec)
    torch.cuda.CUDAGraph.replay = recording
    try:
        _, _, hist = fused_run("cuda", 8, fused_params())
    finally:
        torch.cuda.CUDAGraph.replay = replay
        telemetry.set_recorder(prev)
    assert len(modes) == 9 and set(modes) == {2}     # 2: "error"
    windows = [e for e in rec.events if e["kind"] == "step_window"]
    assert len(windows) == hist.dispatches
    assert sum(e["k"] for e in windows) == hist.wall_iters


# ---------------------------------------------------------------------------
# the MoE family: the index-form layer on the card, and the flash kernels at
# granite-moe-3b-a800m's attention (24 query heads on 8 kv heads of 64)
# ---------------------------------------------------------------------------

def moe_case(arch, dtype, seed=0, **moe):
    """(cfg, layer params on the CPU in ``dtype``, x (2, 64, d) on the CPU
    with its first 3 tokens zero: tied gates)."""
    import dataclasses
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    cfg = reduced(get_config(arch)).replace(dtype=str(dtype).split(".")[1])
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    p = L.cast_tree(M.init_moe_layer(torch.Generator().manual_seed(seed),
                                     cfg, torch.float32, "cpu", None), dtype)
    x = np.random.default_rng(seed + 1).standard_normal((2, 64, cfg.d_model))
    x[:, :3] = 0.0
    return cfg, p, torch.from_numpy(x.astype(np.float32)).to(dtype)


def to_card(tree):
    from repro_torch import tree as TR
    return TR.map(lambda t: t.cuda(), tree)


def routing_of(p, x, cfg):
    from repro_torch.models import moe as M
    b, s, d = x.shape
    tg = M._group_size(b * s, s)
    return M.route(p, x.reshape(b * s // tg, tg, d), cfg, M.capacity(tg, cfg))


MOE_CASES = [("granite-moe-3b-a800m", {}), ("deepseek-moe-16b", {}),
             ("granite-moe-3b-a800m", dict(num_experts=8, top_k=3,
                                           capacity_factor=0.5))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(MOE_CASES)))
def test_moe_layer_on_card_matches_cpu(case, dtype):
    """The index-form layer on the card against the CPU: the same routing
    (``topi``, ``keep``, the slots; the router's products are fp32 on both),
    out at the model tolerance (fp32 1e-4, bf16 3e-2 * (1 + |w|)), aux
    within 1e-5."""
    from repro_torch.models import moe as M
    arch, moe = MOE_CASES[case]
    cfg, p, x = moe_case(arch, dtype, **moe)
    out, aux = M.moe_mlp(to_card(p), x.cuda(), cfg)
    want, want_aux = M.moe_mlp(p, x, cfg)
    r, want_r = routing_of(to_card(p), x.cuda(), cfg), routing_of(p, x, cfg)
    for name in ("topi", "pos", "keep"):
        assert torch.equal(getattr(r, name).cpu(), getattr(want_r, name)), name
    assert out.dtype == dtype and out.is_cuda
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.cpu().float(), want.float(), atol=tol,
                               rtol=tol)
    assert abs(float(aux) - float(want_aux)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(MOE_CASES)))
def test_moe_index_form_matches_one_hot_form_on_card(case):
    """On the card, bf16: the experts' inputs gathered by index bit-equal to
    the one-hot einsum's, the output within one bf16 ulp of the one-hot
    form's (the same k fp32 products summed in other orders, rounded
    once)."""
    from repro_torch.models import moe as M
    arch, moe = MOE_CASES[case]
    cfg, p, x = moe_case(arch, torch.bfloat16, **moe)
    p, x = to_card(p), x.cuda()
    b, s, d = x.shape
    tg = M._group_size(b * s, s)
    g, cap = b * s // tg, M.capacity(tg, cfg)
    xg = x.reshape(g, tg, d)
    r = M.route(p, xg, cfg, cap)
    src, dst = M.slot_maps(r, cap)
    ein = M._Dispatch.apply(x.reshape(-1, d), src, dst)
    dispatch, _, _ = M.topk_dispatch(r.gates, cfg.moe.top_k, cap, x.dtype)
    want = torch.einsum("gtd,gtec->gecd", xg, dispatch)
    assert torch.equal(ein.view(cfg.moe.num_experts, g, cap, d)
                       .transpose(0, 1), want)
    out, _ = M.moe_mlp(p, x, cfg)
    one_hot, _ = M.moe_mlp_onehot(p, x, cfg)
    o, w = out.float(), one_hot.float()
    big = torch.maximum(o.abs(), w.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert bool(((o - w).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_moe_forward_and_backward_give_the_same_bits_twice(arch):
    """Two launches of the layer's forward and backward on the card (bf16,
    40 experts top-8 and a capacity that bites): the dispatch's and the
    combine's backwards are gathers summed in a fixed order, so the output,
    the input's gradient and every leaf's gradient repeat bit for bit."""
    from repro_torch import tree as TR
    from repro_torch.models import moe as M
    cfg, p, x = moe_case(arch, torch.bfloat16, num_experts=40, top_k=8,
                         capacity_factor=0.75)
    runs = []
    for _ in range(2):
        leaves = TR.map(lambda t: t.cuda().requires_grad_(), p)
        xx = x.cuda().requires_grad_()
        out, aux = M.moe_mlp(leaves, xx, cfg)
        (out.float().square().sum() + aux).backward()
        torch.cuda.synchronize()
        runs.append([out, xx.grad] + [t.grad for t in TR.leaves(leaves)])
    assert not routing_of(to_card(p), x.cuda(), cfg).keep.all()
    for a, b in zip(*runs):
        assert a is not None and torch.equal(a, b)


def moe_run(device, window, params, cfg):
    from repro_torch import tree as TR
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches
    trainer = Trainer(Model(cfg, device=device, weights=False),
                      fused_config(window), schedule=FusedForced())
    state, hist = trainer.run(make_batches(cfg, batch=4, seq=64),
                              params=TR.clone(params))
    return trainer, TR.map(lambda t: t.detach().cpu(), state.params), hist


@pytest.mark.gpu
def test_moe_step_captures_and_replays_under_sync_debug_error():
    """A 2-layer granite-shaped MoE (E 8, top-3), ``checkfree_plus`` in
    windows of up to 8 on the card: each replay of the captured step runs
    under ``set_sync_debug_mode("error")`` (the routing reads nothing back
    and makes no shape from the data), and the windows equal the same steps
    run eagerly on the card, and the CPU within 1e-3 * (1 + |w|)."""
    import dataclasses
    cfg = reduced(get_config("granite-moe-3b-a800m")).replace(
        d_model=128, vocab_size=512, max_seq_len=64, dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=8,
                                              top_k=3))
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    modes = []
    replay = torch.cuda.CUDAGraph.replay

    def recording(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        return replay(self)

    torch.cuda.CUDAGraph.replay = recording
    try:
        trainer, p8, h8 = moe_run("cuda", 8, params, cfg)
    finally:
        torch.cuda.CUDAGraph.replay = replay
    assert trainer.window.captures == 1 and len(modes) == 9
    assert set(modes) == {2}                          # 2: "error"
    _, p1, h1 = moe_run("cuda", 1, params, cfg)
    _, pc, hc = moe_run("cpu", 8, params, cfg)
    assert h8.failures == h1.failures == hc.failures == [(5, 1)]
    np.testing.assert_allclose(h8.loss, h1.loss, rtol=1e-5)
    np.testing.assert_allclose(h8.loss, hc.loss, rtol=1e-3, atol=1e-3)
    from repro_torch import tree as TR
    for a, b, c in zip(TR.leaves(p8), TR.leaves(p1), TR.leaves(pc)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(a, c, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [512, 37])
def test_flash_kernels_at_granite_attention_shape(dtype, s):
    """Forward and both backward kernels at 24 query heads on 8 kv heads of
    64 (a group of 3), causal, against their plain versions."""
    q, k, v = qkv(11, 2, 24, 8, s, 64, dtype)
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True, window=0)
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=True, window=0)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    do = qkv(12, 2, 24, 24, s, 64, dtype)[0]
    got = FA.flash_attention_bwd(q, k, v, want, want_lse, do, causal=True,
                                 window=0)
    grads = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, do, True, 0)
    for g, w in zip(got, grads):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **GRAD_TOL[dtype])


# ---------------------------------------------------------------------------
# cross-attention (Sq != Sk) and the encoder-decoder and VLM families
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("d", FA.FWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("sq", [1, 65, 416, 448])
def test_flash_kernels_over_another_key_length(d, dtype, hq, hkv, sq):
    """Cross-attention: Sq query rows over 1500 keys (whisper's frames,
    23 tiles of 64 and a ragged 28), full; the forward and both backward
    kernels against their plain versions, dk and dv Sk rows long."""
    sk = 1500
    rng = np.random.default_rng(sq + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(device="cuda", dtype=dtype)
               for shape in ((1, hq, sq, d), (1, hkv, sk, d), (1, hkv, sk, d)))
    before = (FA.launches, FA.launches_dq, FA.launches_dkv)
    out, lse = FA.flash_attention_fwd(q, k, v, causal=False)
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    do = torch.from_numpy(rng.standard_normal((1, hq, sq, d)).astype(
        np.float32)).to(device="cuda", dtype=dtype)
    got = FA.flash_attention_bwd(q, k, v, want, want_lse, do, causal=False)
    torch.cuda.synchronize()
    assert (FA.launches, FA.launches_dq, FA.launches_dkv) == tuple(
        n + 1 for n in before)
    grads = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, do, False, 0)
    for g, w, name in zip(got, grads, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), **GRAD_TOL[dtype],
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
def test_flash_kernels_refuse_a_mask_over_another_key_length():
    q = torch.zeros((1, 2, 16, 64), device="cuda", dtype=torch.bfloat16)
    k = v = torch.zeros((1, 2, 40, 64), device="cuda", dtype=torch.bfloat16)
    lse = delta = torch.zeros((1, 2, 16), device="cuda")
    before = (FA.launches, FA.launches_dq, FA.launches_dkv)
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="no causal or window mask"):
            FA.flash_attention_fwd(q, k, v, **kw)
        with pytest.raises(ValueError, match="no causal or window mask"):
            FA.flash_attention_bwd_dq(q, k, v, q, lse, delta, **kw)
        with pytest.raises(ValueError, match="no causal or window mask"):
            FA.flash_attention_bwd_dkv(q, k, v, q, lse, delta, **kw)
    assert (FA.launches, FA.launches_dq, FA.launches_dkv) == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-76b"])
def test_encdec_and_vlm_on_card_match_cpu(arch):
    """The reduced models, fp32: prefill (logits and every cache tensor),
    two decode steps and the loss's gradients on the card against the CPU;
    the prefill launches the forward kernel 3 times a decoder layer pair
    (encoder, self, cross) for whisper, once a layer for the VLM."""
    from repro_torch import tree as TR
    from repro_torch.data.pipeline import batch_for
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    params = Model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0)).params
    cpu = Model(cfg, params, device="cpu")
    card = Model(cfg, params, device="cuda")
    raw = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 38))
    batch = {k: torch.from_numpy(v) for k, v in
             batch_for(cfg, raw, np.random.default_rng(4)).items()}
    on_card = {k: t.cuda() for k, t in batch.items()}
    cap = cfg.num_patches + 37 + 4
    before = FA.launches
    logits, cache = card.prefill(on_card, cap)
    torch.cuda.synchronize()
    per = (cfg.num_encoder_layers + 2 * cfg.num_layers
           if cfg.arch_type == "encdec" else cfg.num_layers)
    assert FA.launches == before + per
    want, want_cache = cpu.prefill(batch, cap)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
    for key in want_cache:
        torch.testing.assert_close(cache[key].cpu(), want_cache[key],
                                   atol=1e-4, rtol=1e-4)
    nxt = want[:, -1].argmax(-1).to(torch.int32)
    for _ in range(2):
        logits, cache = card.decode_step(cache, nxt.cuda())
        want, want_cache = cpu.decode_step(want_cache, nxt)
        torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
        nxt = want[:, -1].argmax(-1).to(torch.int32)
    grads = []
    for device, b in (("cuda", on_card), ("cpu", batch)):
        leaves = TR.map(lambda t: t.detach().to(device).requires_grad_(),
                        params)
        loss, _ = Model(cfg, device=device, weights=False).loss(leaves, b)
        loss.backward()
        grads.append((loss, TR.leaves(TR.map(lambda t: t.grad, leaves))))
    (card_loss, card_g), (cpu_loss, cpu_g) = grads
    torch.testing.assert_close(card_loss.cpu(), cpu_loss, atol=1e-4, rtol=1e-4)
    for a, b in zip(card_g, cpu_g):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
def test_adam_kernels_take_every_leaf_of_a_whisper_tree():
    """whisper-large-v3's tree has 33 leaves (its layernorms bring a bias
    each): one launch of each Adam kernel takes them all, against the plain
    versions as above; more than the table holds is refused."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.kernels import adam as AD
    from repro_torch.optim import adam as A
    cfg = reduced(get_config("whisper-large-v3")).replace(dtype="float32")
    tree = Model(cfg, device="cuda", weights=False).init(
        torch.Generator("cuda").manual_seed(0))
    from repro_torch import tree as TR
    from repro_torch.core.stages import StagePartition
    params = TR.leaves(tree)
    assert len(params) == 33 <= AD.MAX_LEAVES
    part = StagePartition(cfg, 2)
    tower = part.tower_flags(tree)
    gen = torch.Generator("cuda").manual_seed(1)
    grads = [torch.randn(p.shape, device=p.device, generator=gen)
             for p in params]
    per_layer, total = AD.adam_sumsq(grads, tower, part.num_layers)
    want_layer, want_total = ref.adam_sumsq_ref(grads, tower, part.num_layers)
    torch.testing.assert_close(per_layer, want_layer, rtol=1e-6, atol=0)
    torch.testing.assert_close(total, want_total, rtol=1e-6, atol=0)
    opt = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    scalars = A.adam_scalars(opt, torch.tensor(5, device="cuda"),
                             torch.tensor(1.0, device="cuda"), total.sqrt())
    m = [0.1 * g for g in grads]
    v = [0.01 * g.square() for g in grads]
    got = ([t.clone() for t in params], [t.clone() for t in m],
           [t.clone() for t in v])
    AD.adam_update(got[0], grads, got[1], got[2], scalars,
                   **A.update_options(opt))
    want = ([t.clone() for t in params], [t.clone() for t in m],
            [t.clone() for t in v])
    ref.adam_update_ref(want[0], grads, want[1], want[2], scalars,
                        **A.update_options(opt))
    for gs, ws in zip(got, want):
        for a, w in zip(gs, ws):
            assert bool(((a - w).abs() <= 1e-6 * (1 + w.abs())).all())
    many = grads * 2
    with pytest.raises(ValueError, match="table holds"):
        AD.adam_sumsq(many, tower * 2, part.num_layers)


def encdec_run(device, window, params):
    from repro_torch import tree as TR
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches
    cfg = reduced(get_config("whisper-large-v3")).replace(
        num_encoder_layers=4, dtype="float32")
    trainer = Trainer(Model(cfg, device=device, weights=False),
                      fused_config(window), schedule=FusedForced())
    state, hist = trainer.run(make_batches(cfg, batch=4, seq=64),
                              params=TR.clone(params))
    return trainer, TR.map(lambda t: t.detach().cpu(), state.params), hist


@pytest.mark.gpu
def test_whisper_captured_windows_match_eager_steps_on_card():
    """Reduced whisper (4 encoder layers in 2 stages), ``checkfree_plus``,
    windows of 8 (graph replays) against eager steps on the card, within
    1e-5 relative; each captured step launches the forward, dq and dkv
    kernels 16 times (two halves of 4 encoder, 2 self and 2 cross)."""
    from repro_torch import tree as TR
    cfg = reduced(get_config("whisper-large-v3")).replace(
        num_encoder_layers=4, dtype="float32")
    params = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    trainer, p8, h8 = encdec_run("cuda", 8, params)
    _, p1, h1 = encdec_run("cuda", 1, params)
    assert h8.failures == h1.failures == [(5, 1)]
    assert h8.dispatches < h1.dispatches
    np.testing.assert_allclose(h8.loss, h1.loss, rtol=1e-5)
    for a, b in zip(TR.leaves(p8), TR.leaves(p1)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    recorded = trainer.window.recorded_launches
    assert trainer.window.captures == 1
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert recorded[name] == 16, (name, recorded)


# ---------------------------------------------------------------------------
# the pipeline backend: four ranks of the card
# ---------------------------------------------------------------------------

SPMD_STAGES, SPMD_STEPS = 4, 4
SPMD_RECOVERIES = ((2, "grad_norm"), (0, "grad_norm"), (1, "copy_prev"))


def _spmd_config():
    return reduced(get_config("paper-llama-124m")).replace(
        num_layers=2 * SPMD_STAGES, dtype="float32")


def _spmd_rank(rank, device, params):
    """One rank: a ``checkfree_plus`` run on ``device`` (a merge of stage 2
    at wall 2) from ``params``, and on the card the in-mesh recoveries of
    SPMD_RECOVERIES from the same parameters."""
    from repro_torch import tree as TR
    from repro_torch.config import (OptimizerConfig, RecoveryConfig,
                                    TrainConfig)
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.stages import StagePartition
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches
    from repro_torch.pipeline import spmd

    class Forced:
        def at(self, step):
            return [2] if step == 2 else []

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _spmd_config()
    tcfg = TrainConfig(global_batch=8, microbatch=4, seq_len=32,
                       steps=SPMD_STEPS, fuse_window=2,
                       optimizer=OptimizerConfig(lr=1e-3,
                                                 total_steps=SPMD_STEPS),
                       recovery=RecoveryConfig(strategy="checkfree_plus",
                                               num_stages=SPMD_STAGES))
    before = ops.launch_counts()
    trainer = Trainer(Model(cfg, device=device, weights=False), tcfg,
                      schedule=Forced(), backend="spmd")
    state, hist = trainer.run(make_batches(cfg, batch=8, seq=32, seed=0),
                              params=params_from_numpy(params, device=device))
    after = ops.launch_counts()
    out = {"hist": hist,
           "params": TR.map(lambda t: t.detach().cpu().numpy(), state.params),
           "launches": {k: after[k] - before[k] for k in after}}
    if device == "cuda":
        part = StagePartition(cfg, SPMD_STAGES)
        rec = spmd.make_in_mesh_recover(trainer.transport, part)
        omegas = torch.tensor([1.0, 3.0, 0.5, 2.0], device="cuda")
        out["recovered"] = []
        for failed, reinit in SPMD_RECOVERIES:
            shard = spmd.shard_params(params_from_numpy(params,
                                                        device="cuda"),
                                      part, rank)
            rec(shard, omegas, failed, reinit)
            out["recovered"].append(
                TR.map(lambda t: t.cpu().numpy(), shard["blocks"]))
    return out


@pytest.fixture(scope="module")
def spmd_runs(tmp_path_factory):
    if not torch.cuda.is_available():        # runs before _gpu_marker
        pytest.skip("gpu test: no CUDA device")
    from repro_torch import tree as TR
    from repro_torch.launch.mesh import spawn_stages
    params = TR.map(lambda t: t.numpy(), Model(
        _spmd_config(), device="cpu", weights=False).init(
            torch.Generator().manual_seed(0)))
    return params, {device: spawn_stages(
        _spmd_rank, SPMD_STAGES, device, params, cuda=device == "cuda",
        timeout_s=600,
        workdir=str(tmp_path_factory.mktemp(device)))
        for device in ("cuda", "cpu")}


@pytest.mark.gpu
def test_spmd_on_the_card_matches_the_cpu(spmd_runs):
    """Four ranks on the card (kernels, gloo through pinned host memory)
    against four on the CPU (plain versions): the same failures, losses and
    parameters at 1e-3 * (1 + |w|); every rank on the card launched the
    flash and Adam kernels, rank 2 the merge."""
    _, runs = spmd_runs
    card, cpu = runs["cuda"], runs["cpu"]
    assert card[0]["hist"].failures == cpu[0]["hist"].failures == [(2, 2)]
    for a, b in zip(card[0]["hist"].loss, cpu[0]["hist"].loss):
        assert abs(a - b) <= 1e-3 * (1 + abs(b))
    for r, (x, y) in enumerate(zip(card, cpu)):
        for a, b in zip(_leaves(x["params"]), _leaves(y["params"])):
            assert np.all(np.abs(a - b) <= 1e-3 * (1 + np.abs(b))), r
        n = x["launches"]
        assert n["flash_attention_fwd"] == n["flash_attention_bwd_dq"] == \
            n["flash_attention_bwd_dkv"] == 2 * 2 * 2 * SPMD_STEPS
        assert n["adam_sumsq"] == n["adam_update"] == SPMD_STEPS
        assert n["stage_merge"] == (1 if r == 2 else 0)
        assert not any(y["launches"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(SPMD_RECOVERIES)))
def test_spmd_in_mesh_recovery_is_bit_equal_on_the_card(spmd_runs, case):
    """Neighbour transfers into the failed rank, merged there by the merge
    kernel, against ``recover_stage`` on the whole tree on the card."""
    from repro_torch import tree as TR
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.recovery import recover_stage
    from repro_torch.core.stages import StagePartition
    params, runs = spmd_runs
    failed, reinit = SPMD_RECOVERIES[case]
    want = recover_stage(params_from_numpy(params, device="cuda"),
                         StagePartition(_spmd_config(), SPMD_STAGES), failed,
                         torch.tensor([1.0, 3.0, 0.5, 2.0], device="cuda"),
                         strategy=reinit)
    got = TR.map(lambda *xs: np.concatenate(xs),
                 *[r["recovered"][case] for r in runs["cuda"]])
    for a, b in zip(_leaves(got), _leaves(TR.map(lambda t: t.cpu().numpy(),
                                                 want["blocks"]))):
        np.testing.assert_array_equal(a, b)


def _leaves(tree):
    from repro_torch import tree as TR
    return TR.leaves(tree)


# the snapshot strategies on the pipeline backend: a rollback of every rank
# to the save at step 2, and stage 1 restored from its neighbour's memory
SPMD_STORE_RUNS = {"checkpoint": ({3: [2]}, dict(checkpoint_every=2),
                                  [1, 2, 3, 3, 4]),
                   "neighbor": ({2: [1]}, dict(neighbor_cold=False),
                                [1, 2, 3, 4])}


def _spmd_store_rank(rank, device, params, directory):
    """One rank: each run of SPMD_STORE_RUNS on ``device``, with a host
    copy of the rank's whole state (parameters, moments, Adam's step) after
    every step, and whether the state after each restore equals, bit for
    bit, the copy of the step it restored."""
    import os

    from repro_torch import tree as TR
    from repro_torch.config import (OptimizerConfig, RecoveryConfig,
                                    TrainConfig)
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches

    class Forced:
        def __init__(self, events):
            self.events = events

        def at(self, step):
            return list(self.events.get(step, []))

    def host(state):
        opt = state.opt_state
        return (TR.map(lambda t: t.detach().cpu().clone(),
                       {"params": state.params, "m": opt.m, "v": opt.v}),
                opt.step)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _spmd_config()
    out = {}
    for name, (events, rcfg, _) in SPMD_STORE_RUNS.items():
        tcfg = TrainConfig(
            global_batch=8, microbatch=4, seq_len=32, steps=SPMD_STEPS,
            fuse_window=2,
            optimizer=OptimizerConfig(lr=1e-3, total_steps=SPMD_STEPS),
            recovery=RecoveryConfig(
                strategy=name, num_stages=SPMD_STAGES,
                checkpoint_dir=os.path.join(directory, name, "ckpt"),
                store_dir=os.path.join(directory, name, "store"), **rcfg))
        trainer = Trainer(Model(cfg, device=device, weights=False), tcfg,
                          schedule=Forced(events), backend="spmd")
        strategy = trainer.strategy
        after_step, handle = strategy.after_step, strategy.handle_failure
        kept, restored = {}, []

        def keep(state, hist, _after=after_step, _kept=kept):
            _after(state, hist)
            _kept[state.effective_step] = host(state)

        def check(state, event, _handle=handle, _kept=kept,
                  _restored=restored):
            state = _handle(state, event)
            (live, step), (want, want_step) = host(state), \
                _kept[state.effective_step]
            _restored.append((state.effective_step, step == want_step and all(
                torch.equal(a, b) for a, b in zip(TR.leaves(live),
                                                  TR.leaves(want)))))
            return state

        strategy.after_step, strategy.handle_failure = keep, check
        before = ops.launch_counts()
        state, hist = trainer.run(
            make_batches(cfg, batch=8, seq=32, seed=0),
            params=params_from_numpy(params, device=device))
        after = ops.launch_counts()
        out[name] = {"hist": hist, "restored": restored,
                     "restore_log": getattr(strategy, "restore_log", None),
                     "launches": {k: after[k] - before[k] for k in after}}
    return out


@pytest.fixture(scope="module")
def spmd_store_runs(tmp_path_factory):
    if not torch.cuda.is_available():        # runs before _gpu_marker
        pytest.skip("gpu test: no CUDA device")
    from repro_torch import tree as TR
    from repro_torch.launch.mesh import spawn_stages
    params = TR.map(lambda t: t.numpy(), Model(
        _spmd_config(), device="cpu", weights=False).init(
            torch.Generator().manual_seed(0)))
    return {device: spawn_stages(
        _spmd_store_rank, SPMD_STAGES, device, params,
        str(tmp_path_factory.mktemp(device + "_dirs")),
        cuda=device == "cuda", timeout_s=600,
        workdir=str(tmp_path_factory.mktemp(device)))
        for device in ("cuda", "cpu")}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SPMD_STORE_RUNS))
def test_spmd_snapshot_strategies_on_the_card_match_the_cpu(spmd_store_runs,
                                                            name):
    """``checkpoint`` rolls every rank back to its save, ``neighbor``
    restores stage 1 from its neighbour's memory: four ranks on the card
    against four on the CPU, the same trace, restore log and losses at
    1e-3 * (1 + |loss|); on both, every rank's state after the restore
    bit-equal to its copy of the step restored; the kernels launched on
    every rank of the card."""
    events, _, trace = SPMD_STORE_RUNS[name]
    card = [r[name] for r in spmd_store_runs["cuda"]]
    cpu = [r[name] for r in spmd_store_runs["cpu"]]
    hist = card[0]["hist"]
    assert hist.steps == cpu[0]["hist"].steps == trace
    assert hist.failures == cpu[0]["hist"].failures == \
        [(w, s) for w in events for s in events[w]]
    for a, b in zip(hist.loss, cpu[0]["hist"].loss):
        assert abs(a - b) <= 1e-3 * (1 + abs(b))
    for r, (x, y) in enumerate(zip(card, cpu)):
        assert x["hist"].to_json() == hist.to_json(), r
        assert x["restore_log"] == y["restore_log"] == card[0]["restore_log"]
        assert x["restored"] == y["restored"] == [(2, True)], r
        n = x["launches"]
        walls = len(trace)
        assert n["flash_attention_fwd"] == n["flash_attention_bwd_dq"] == \
            n["flash_attention_bwd_dkv"] == 2 * 2 * walls
        assert n["adam_sumsq"] == n["adam_update"] == walls
        assert n["stage_merge"] == 0
        assert not any(y["launches"].values())


# ---------------------------------------------------------------------------
# remat and the dry-run's meta branches
# ---------------------------------------------------------------------------

def _remat_run(cfg, params, batch, remat, monkeypatch, policy="nothing"):
    """(loss, gradients, launches) of ``Model.loss`` on the card."""
    from repro_torch import tree as TR
    monkeypatch.setenv("REPRO_REMAT", policy)
    leaves = [p.detach().clone().requires_grad_() for p in TR.leaves(params)]
    it = iter(leaves)                  # map visits the leaves in this order
    tree = TR.map(lambda _: next(it), params)
    before = ops.launch_counts()
    loss, _ = Model(cfg, device="cuda", weights=False).loss(tree, batch,
                                                            remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    return loss.detach(), grads, {k: after[k] - before[k] for k in after}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["paper-llama-124m", "mamba2-1.3b",
                                  "granite-moe-3b-a800m"])
def test_remat_on_and_off_agree_on_the_card(arch, monkeypatch):
    """2-layer models at their reduced widths, bf16 compute on fp32
    masters: remat on ("nothing", "dots") against off within
    1e-5 * (1 + |w|); bit-equality is reported in the assertion message."""
    from repro_torch import tree as TR
    from repro_torch.data.pipeline import make_batches
    cfg = reduced(get_config(arch))
    params = TR.map(lambda t: t.float(), Model(
        cfg, device="cuda",
        generator=torch.Generator("cuda").manual_seed(0)).params)
    raw = next(make_batches(cfg, batch=2, seq=128, seed=0))
    batch = {k: torch.as_tensor(v).cuda() for k, v in raw.items()}
    want = _remat_run(cfg, params, batch, False, monkeypatch)
    for policy in ("nothing", "dots"):
        got = _remat_run(cfg, params, batch, True, monkeypatch, policy)
        equal = torch.equal(got[0], want[0]) and all(
            torch.equal(g, w) for g, w in zip(got[1], want[1]))
        for g, w in [(got[0], want[0]), *zip(got[1], want[1])]:
            err = (g.float() - w.float()).abs()
            assert bool((err <= 1e-5 * (1 + w.float().abs())).all()), (
                policy, float(err.max()), f"bit-equal: {equal}")


@pytest.mark.gpu
def test_flash_forward_launches_under_each_remat_policy(monkeypatch):
    """The flash forward runs once a layer without remat and under "dots"
    (its out and lse are kept), twice under "nothing"; dq and dkv once."""
    from repro_torch import tree as TR
    from repro_torch.data.pipeline import make_batches
    cfg = reduced(get_config("paper-llama-124m"))
    params = TR.map(lambda t: t.float(), Model(
        cfg, device="cuda",
        generator=torch.Generator("cuda").manual_seed(0)).params)
    raw = next(make_batches(cfg, batch=2, seq=64, seed=0))
    batch = {k: torch.as_tensor(v).cuda() for k, v in raw.items()}
    n = cfg.num_layers
    for remat, policy, fwd in ((False, "nothing", n), (True, "nothing", 2 * n),
                               (True, "dots", n)):
        launched = _remat_run(cfg, params, batch, remat, monkeypatch,
                              policy)[2]
        assert launched["flash_attention_fwd"] == fwd, (remat, policy)
        assert launched["flash_attention_bwd_dq"] == n
        assert launched["flash_attention_bwd_dkv"] == n


@pytest.mark.gpu
def test_meta_dispatch_raises_nothing_and_launches_nothing():
    """The dry-run on meta tensors, next to a card: every kernel's meta
    branch answers, and no kernel launches."""
    from repro_torch.launch import dryrun as DR
    before = ops.launch_counts()
    for arch, shape in (("paper-llama-124m", "train_4k"),
                        ("mamba2-1.3b", "train_4k"),
                        ("zamba2-2.7b", "prefill_32k")):
        cfg = reduced(get_config(arch))
        rec = DR.run_one(arch, shape, mesh="1x1", cfg=cfg, batch=2, seq=64,
                         verbose=False)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["kernels"]
    assert ops.launch_counts() == before


class GuardForced:
    def __init__(self, events):
        self.events = dict(events)

    def at(self, step):
        return list(self.events.get(step, []))


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,steps,events", [
    ("none", 16, {}), ("checkfree", 10, {5: [1]})])
def test_trainer_runs_under_the_guard_with_one_capture(strategy, steps,
                                                       events):
    """tests/test_torch_runtime_guards.py's two runs on the card, under
    ``guarded()`` (``set_sync_debug_mode("error")`` from the set-up to the
    last drain): windows of 8, one full and one cut by the failure, replay
    the one captured graph; every host read is an explicit drain."""
    from repro_torch import tree as TR
    from repro_torch.analysis import runtime
    from repro_torch.config import (ModelConfig, OptimizerConfig,
                                    RecoveryConfig, TrainConfig)
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import make_batches

    # the guard tests' 4-layer llama at head dim 64 (the kernels' smallest
    # but one)
    cfg = ModelConfig(
        name="guard-llama", arch_type="dense", num_layers=4, d_model=128,
        num_heads=2, num_kv_heads=2, d_ff=256, vocab_size=128,
        max_seq_len=32, dtype="float32", param_dtype="float32")
    tcfg = TrainConfig(global_batch=4, microbatch=4, seq_len=32, steps=steps,
                       eval_every=100, fuse_window=8,
                       optimizer=OptimizerConfig(lr=1e-3, total_steps=steps,
                                                 warmup_steps=2),
                       recovery=RecoveryConfig(strategy=strategy,
                                               num_stages=4))
    trainer = Trainer(Model(cfg, device="cuda", weights=False), tcfg,
                      schedule=GuardForced(events))
    drains = TR.explicit_counts["drain"]
    before = ops.launch_counts()
    with runtime.guarded():
        assert torch.cuda.get_sync_debug_mode() == 2
        _, hist = trainer.run(make_batches(cfg, batch=4, seq=32, seed=0))
    assert torch.cuda.get_sync_debug_mode() == 0
    assert np.isfinite(hist.loss).all() and len(hist.loss) == steps
    runtime.assert_capture_bound(trainer, 1)
    assert TR.explicit_counts["drain"] - drains == \
        hist.dispatches + len(hist.recovery_errors)
    if strategy == "none":
        assert hist.dispatches == 2 and trainer.dispatched_buckets == {8}
    else:
        assert hist.failures == [(5, 1)] and len(hist.recovery_errors) == 1
        assert len(trainer.dispatched_buckets) > 1
        assert ops.launch_counts()["stage_merge"] > before["stage_merge"]
