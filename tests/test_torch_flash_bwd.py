"""The port's flash-attention backward against the JAX package's.

On the CPU the port runs plain versions: ``flash_attention_bwd_ref`` (the
function of the two backward kernels) and PyTorch's autograd through
``flash_attention_ref`` are held against the Pallas backward kernels in
interpret mode (``_bwd_call``), over the cases of tests/test_kernels.py's VJP
tests.  Tolerance: that file's 2e-4 for fp32; bf16 gradients stay bf16 and
are held at 3e-2.  The CUDA kernels are held against these plain versions on
the card in tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _bwd_call, _fwd_call
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR

TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def make(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, s, d))]


def check(arrs, dtype, *, causal, window, blk):
    """(dq, dk, dv) of the port's plain versions against JAX's kernels."""
    jq, jk, jv, jdo = (jnp.asarray(a).astype(dtype) for a in arrs)
    jo, jlse = _fwd_call(jq, jk, jv, causal, window, blk, blk, True)
    want = _bwd_call(jq, jk, jv, jo, jlse, jdo, causal, window, blk, blk, True)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(getattr(torch, dtype))
                       for a in arrs)
    out, lse = TR.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    got = TR.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal, window)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o, _ = TR.flash_attention_ref(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(o, leaves, tdo)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, auto, want):
        assert g.dtype == a.dtype == getattr(torch, dtype), name
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, **TOL[dtype],
                                   err_msg=f"{name} (bwd_ref)")
        np.testing.assert_allclose(a.float().numpy(), w, **TOL[dtype],
                                   err_msg=f"{name} (autograd)")


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_backward_causal_gqa(hq, hkv):
    check(make(10, 2, hq, hkv, 64, 32), "float32", causal=True, window=0,
          blk=32)


@pytest.mark.parametrize("window", [16, 48, 100])
def test_backward_sliding_window(window):
    check(make(11, 1, 2, 2, 128, 32), "float32", causal=True, window=window,
          blk=32)


def test_backward_non_causal():
    check(make(12, 1, 2, 2, 64, 32), "float32", causal=False, window=0, blk=32)


def test_backward_bf16_keeps_bf16_grads():
    check(make(13, 1, 2, 2, 64, 32), "bfloat16", causal=True, window=0, blk=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,d,window", [(4, 4, 80, 0), (4, 2, 120, 48),
                                             (4, 1, 256, 0)])
def test_backward_at_head_dims_80_120_256(dtype, hq, hkv, d, window):
    """zamba2's head dim 80, h2o-danube-3-4b's 120 (GQA, a window) and
    gemma-2b's 256 (MQA), which the backward kernels are built for too."""
    check(make(17, 1, hq, hkv, 64, d), dtype, causal=True, window=window,
          blk=32)


def test_backward_ragged_length_matches_autograd():
    """S = 37 is no multiple of a tile (the Pallas wrapper refuses it)."""
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in make(14, 2, 4, 2, 37, 32))
    out, lse = TR.flash_attention_ref(tq, tk, tv, causal=True, window=8)
    got = TR.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, True, 8)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o, _ = TR.flash_attention_ref(*leaves, causal=True, window=8)
    for g, a in zip(got, torch.autograd.grad(o, leaves, tdo)):
        torch.testing.assert_close(g, a, atol=2e-5, rtol=2e-5)


def test_ops_flash_attention_keeps_the_graph_on_cpu():
    """The plain path is differentiable: ops.flash_attention keeps
    requires_grad and a grad_fn for CPU inputs, and q, k, v get gradients."""
    tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2)
                       for a in make(15, 2, 4, 2, 24, 32))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=True, window=0)
    assert out.requires_grad and out.grad_fn is not None
    (out * tdo).sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in make(16, 1, 2, 2, 64, 32))
    out, lse = TR.flash_attention_ref(tq, tk, tv)
    before = (FA.launches_dq, FA.launches_dkv)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd(tq, tk, tv, out, lse, tdo)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        FA.FlashAttention.apply(tq, tk, tv, True, 0)
    assert (FA.launches_dq, FA.launches_dkv) == before
