"""The port's flash-attention forward against the JAX package's.

On the CPU the port runs the plain version (``repro_torch.kernels.ref``): it
is held against the Pallas forward kernel in interpret mode (``_fwd_call``,
out and lse) and against ``repro.kernels.ref.flash_attention_ref``, over the
sweep of ``tests/test_kernels.py`` and at head dims 120 and 256 with MQA.
Tolerances are that file's: fp32 2e-5, bf16 3e-2; lse 1e-4.  The CUDA kernel itself is held against the plain
version on the card in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.flash_attention import _fwd_call
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-4)


def make_qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def to_jax(arrs, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def to_torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def lse_numpy(q, k, *, causal, window):
    """Row logsumexp of the masked logits, in float64."""
    q, k = q.astype(np.float64), k.astype(np.float64)
    g = q.shape[1] // k.shape[1]
    k = np.repeat(k, g, axis=1)
    s, d = q.shape[2], q.shape[3]
    logits = np.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(d)
    qpos, kpos = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = np.where(mask, logits, -np.inf)
    m = logits.max(-1, keepdims=True)
    return (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]


def check_plain_against_jax(arrs, dtype, *, causal, window, blk):
    jq, jk, jv = to_jax(arrs, dtype)
    tq, tk, tv = to_torch(arrs, dtype)
    out, lse = TR.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    p_out, p_lse = _fwd_call(jq, jk, jv, causal, window, blk, blk, True)
    want = JR.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(p_out, np.float32), **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(p_lse), **LSE_TOL)


@pytest.mark.parametrize("s,blk", [(64, 32), (128, 64), (256, 128)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_plain_causal_gqa(s, blk, hq, hkv):
    arrs = make_qkv(3, 1, hq, hkv, s, 32)
    check_plain_against_jax(arrs, "float32", causal=True, window=0, blk=blk)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_plain_sliding_window(window):
    arrs = make_qkv(4, 2, 2, 2, 128, 32)
    check_plain_against_jax(arrs, "float32", causal=True, window=window, blk=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dtypes(dtype):
    arrs = make_qkv(5, 1, 2, 2, 64, 64)
    check_plain_against_jax(arrs, dtype, causal=True, window=0, blk=32)


def test_plain_non_causal():
    arrs = make_qkv(6, 1, 2, 2, 64, 32)
    check_plain_against_jax(arrs, "float32", causal=False, window=0, blk=32)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_plain_ragged_length(causal, window):
    """S = 37 is no multiple of a tile (the Pallas wrapper refuses it)."""
    arrs = make_qkv(7, 2, 4, 2, 37, 32)
    tq, tk, tv = to_torch(arrs, "float32")
    out, lse = TR.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    want = JR.flash_attention_ref(*to_jax(arrs, "float32"), causal=causal,
                                  window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL["float32"])
    np.testing.assert_allclose(lse.numpy(), lse_numpy(arrs[0], arrs[1],
                                                      causal=causal,
                                                      window=window),
                               **LSE_TOL)


@pytest.mark.parametrize("d", [120, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_plain_at_head_dims_120_and_256(d, dtype, causal, window):
    """h2o-danube-3-4b's and gemma-2b's head dims, MQA (4 query heads on one
    kv head), against the Pallas kernel in interpret mode and the JAX
    reference."""
    arrs = make_qkv(10, 1, 4, 1, 64, d)
    check_plain_against_jax(arrs, dtype, causal=causal, window=window, blk=32)


def test_head_dims_each_direction_is_built_for():
    """Both directions take 120 and 256 (a CPU tensor is then refused for its
    device, not its head dim); a head dim neither is built for, 48, is
    refused by head dim in both."""
    assert FA.FWD_HEAD_DIMS == (16, 32, 64, 80, 120, 128, 256)
    assert FA.BWD_HEAD_DIMS == FA.FWD_HEAD_DIMS
    whats = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    for d in (120, 256):
        q = torch.zeros((1, 2, 16, d))
        with pytest.raises(ValueError, match="CUDA"):
            FA._check("flash_attention_fwd", q, q, q, 0)
        for what in whats:
            with pytest.raises(ValueError, match="CUDA"):
                FA._check(what, q, q, q, 0, FA.BWD_HEAD_DIMS, do=q)
    q = torch.zeros((1, 2, 16, 48))
    with pytest.raises(NotImplementedError, match="head dim 48"):
        FA._check("flash_attention_fwd", q, q, q, 0)
    for what in whats:
        with pytest.raises(NotImplementedError, match="head dim 48"):
            FA._check(what, q, q, q, 0, FA.BWD_HEAD_DIMS, do=q)


def test_ops_takes_model_layout_on_cpu():
    arrs = make_qkv(8, 2, 4, 2, 24, 32)
    tq, tk, tv = to_torch(arrs, "float32")
    got = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=True, window=8)
    want, _ = TR.flash_attention_ref(tq, tk, tv, causal=True, window=8)
    assert got.shape == (2, 24, 4, 32)
    torch.testing.assert_close(got, want.transpose(1, 2), atol=0, rtol=0)


def test_ops_raises_off_cpu_and_cuda():
    """Another device raises; meta takes the kernel's meta branch (the
    dry-run's shapes: no launch, no plain version)."""
    q = torch.empty((1, 64, 2, 32)).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="xpu"):
        ops.flash_attention(q, q, q)
    before = FA.launches
    q = torch.empty((1, 64, 2, 32), device="meta")
    assert ops.flash_attention(q, q, q).shape == q.shape
    assert FA.launches == before


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports another device, ``xpu``, for which the port
    has no kernel and no plain version."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__self__", None) is torch.Tensor.device:
            return torch.device("xpu")
        return super().__torch_function__(func, types, args, kwargs or {})


def test_kernel_wrapper_refuses_cpu_tensors():
    tq, tk, tv = to_torch(make_qkv(9, 1, 2, 2, 64, 32), "float32")
    before = FA.launches
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_fwd(tq, tk, tv)
    assert FA.launches == before
