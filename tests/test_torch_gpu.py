"""The port's CUDA kernel and model on the card (tests marked ``gpu``).

Each test skips where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The kernel is held against its plain version on the same inputs at the
tolerances of tests/test_kernels.py (fp32 2e-5, bf16 3e-2; lse 1e-4), and
the model on the card against the same model on the CPU at 1e-4 (fp32, with
TF32 off; cuBLAS and the CPU sum in different orders).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 32), (8, 2, 64), (4, 1, 128)])
@pytest.mark.parametrize("s,causal,window", [(128, True, 0), (200, True, 100),
                                             (77, False, 0), (1, True, 0)])
def test_kernel_matches_plain(dtype, hq, hkv, d, s, causal, window):
    q, k, v = qkv(0, 2, hq, hkv, s, d, dtype)
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


@pytest.mark.gpu
@pytest.mark.parametrize("arch,s", [("qwen3-4b", 37), ("paper-llama-124m", 64)])
def test_model_on_card_matches_cpu(arch, s):
    cfg = reduced(get_config(arch)).replace(dtype="float32")
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
