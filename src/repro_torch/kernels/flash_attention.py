"""Flash attention on the H100: the wrappers of ``csrc/flash_attention_fwd.cu``
and ``csrc/flash_attention_bwd.cu``, and the autograd Function over them.

The kernels replace the TPU kernels of ``repro/kernels/flash_attention.py``:
``_flash_kernel`` (forward), ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
(backward).  All three run bf16 on the tensor cores and fp32 on the CUDA
cores (an fp32 tensor-core product would be TF32).  This module takes
tensors that lie on a CUDA device and nothing else: the plain versions for
CPU tensors are in ``kernels.ref``, and ``kernels.ops`` picks between them by
the tensor's device.

:class:`FlashAttention` is the counterpart of the JAX ``custom_vjp``: its
forward launches the forward kernel and saves ``(q, k, v, out, lse)``; its
backward computes ``delta = rowsum(dO * O)`` in fp32 outside the kernels, as
the JAX code does, and launches the dq and dkv kernels.

k and v may be longer or shorter than q (Sk != Sq) for cross-attention,
which is full attention (``causal=False, window=0``); any other mask over
Sq != Sk is refused, as no path needs it and the JAX code defines none.

``launches``, ``launches_dq`` and ``launches_dkv`` count each kernel's
launches in this process.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

# head dims each direction is built for, both the same: zamba2's 80,
# h2o-danube-3-4b's 120 and gemma-2b's 256 beside 32, 64 and 128
FWD_HEAD_DIMS = (32, 64, 80, 120, 128, 256)
BWD_HEAD_DIMS = FWD_HEAD_DIMS
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_dq = 0
launches_dkv = 0

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# without argtypes ctypes passes each pointer as a 32-bit int and cuts it
_ARGTYPES = {
    "flash_attention_fwd": [_P] * 5 + [_I] * 7 + [_LL] * 12 + [_I, _I, _F, _P],
    "flash_attention_bwd_dq": [_P] * 7 + [_I] * 7 + [_LL] * 15 + [_I, _I, _F, _P],
    "flash_attention_bwd_dkv": [_P] * 8 + [_I] * 7 + [_LL] * 18 + [_I, _I, _F, _P],
}


def _entry(library: str, name: str):
    lib = build.load(library)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _aligned(t: torch.Tensor) -> bool:
    """A contiguous last axis and rows that start on 16-byte boundaries."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and not any(
        st * t.element_size() % 16 for st in t.stride()[:3])


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, dims=FWD_HEAD_DIMS, *, causal: bool = True,
           **more: torch.Tensor) -> None:
    """Refuse what the kernel named ``what`` was not built for; the head dim
    first, against ``dims``, the head dims of that direction.  k/v of
    another length than q only for full attention (cross-attention)."""
    if q.shape[-1] not in dims:
        raise NotImplementedError(
            f"{what}: head dim {q.shape[-1]} is not built (supported: "
            f"{dims}); other head dims are an open item of ROADMAP.md "
            "(queue 2, flash attention)")
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.device.type != "cuda":
            raise ValueError(
                f"{what}: {name} is on {t.device}; the kernel takes CUDA "
                "tensors (CPU tensors go to kernels.ref through kernels.ops)")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{what}: {name} is {t.dtype}; q, k, v (and dO) "
                            "must all be float32 or all bfloat16")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be (B, H, S, D), got "
                             f"{tuple(t.shape)}")
        if not _aligned(t):
            raise ValueError(
                f"{what}: {name} needs a contiguous last axis and rows that "
                f"start on 16-byte boundaries, got strides {t.stride()}")
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if k.shape[2] != s and (causal or window):
        raise ValueError(
            f"{what}: q of {s} rows over k/v of {k.shape[2]} takes no causal "
            f"or window mask (causal={causal}, window={window}); a query "
            "length other than the key length is cross-attention, full")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{what}: {hq} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not shaped "
                             f"like q {tuple(q.shape)}")
    if s == 0 or k.shape[2] == 0 or window < 0:
        raise ValueError(f"{what}: Sq={s}, Sk={k.shape[2]}, window={window}")


def _like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor in t's memory layout when it has a contiguous last axis."""
    out = torch.empty_like(t)
    if out.stride(-1) != 1:
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out


def _rows(t: torch.Tensor, name: str, like: torch.Tensor) -> torch.Tensor:
    """lse / delta: contiguous fp32 (B, Hq, S) on q's device."""
    if (t.dtype != torch.float32 or t.shape != like.shape[:3]
            or t.device != like.device):
        raise ValueError(f"{name} must be fp32 {tuple(like.shape[:3])} on "
                         f"{like.device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (out like q, lse (B, Hq, Sq)).

    Any strides with a contiguous last axis: ``out`` takes q's memory layout,
    so a transposed view of the model's (B, S, H, D) tensors goes in and
    comes out without a copy.  Launches on the current stream and does not
    synchronise.  No autograd: :class:`FlashAttention` carries the gradient.
    """
    global launches
    _check("flash_attention_fwd", q, k, v, window, causal=causal)
    b, hq, s, d = q.shape
    out = _like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib, fn = _entry("flash_attention_fwd", "flash_attention_fwd")
    with torch.cuda.device(q.device):      # the C side launches on the current device
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODES[q.dtype], b, hq, k.shape[1], s,
                 k.shape[2], d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], int(causal), int(window),
                 1.0 / math.sqrt(d),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_fwd")
    launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """dQ (like q) from q, k, v, dO and the fp32 (B, Hq, Sq) lse and delta."""
    global launches_dq
    _check("flash_attention_bwd_dq", q, k, v, window, BWD_HEAD_DIMS,
           causal=causal, do=do)
    b, hq, s, d = q.shape
    lse, delta = _rows(lse, "lse", q), _rows(delta, "delta", q)
    dq = _like(q)
    lib, fn = _entry("flash_attention_bwd", "flash_attention_bwd_dq")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, hq, k.shape[1], s, k.shape[2], d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *do.stride()[:3], *dq.stride()[:3], int(causal), int(window),
                 1.0 / math.sqrt(d),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_bwd_dq")
    launches_dq += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: int = 0,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK like k, dV like v), each summed over its GQA group of query heads."""
    global launches_dkv
    _check("flash_attention_bwd_dkv", q, k, v, window, BWD_HEAD_DIMS,
           causal=causal, do=do)
    b, hq, s, d = q.shape
    lse, delta = _rows(lse, "lse", q), _rows(delta, "delta", q)
    dk, dv = _like(k), _like(v)
    lib, fn = _entry("flash_attention_bwd", "flash_attention_bwd_dkv")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, hq, k.shape[1], s, k.shape[2], d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *do.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
                 int(causal), int(window), 1.0 / math.sqrt(d),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_bwd_dkv")
    launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): ``delta = rowsum(dO * O)`` in fp32, then both kernels.

    ``dO`` from autograd may be non-contiguous or misaligned for the
    kernels' 16-byte rows; it is made contiguous here, never in a kernel.
    """
    if not _aligned(do):
        do = do.contiguous()
    delta = (do.float() * out.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                window=window)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                     window=window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Kernel layout: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> out like q;
    the backward gives dk/dv like k/v (Sk rows)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
