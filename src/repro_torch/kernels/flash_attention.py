"""Flash-attention forward on the H100: the wrapper of
``csrc/flash_attention_fwd.cu``.

The kernel replaces the TPU kernel ``_flash_kernel`` of
``repro/kernels/flash_attention.py`` (forward only; the two backward kernels
come with the training slice).  This module takes tensors that lie on a CUDA
device and nothing else: the plain version for CPU tensors is
``kernels.ref.flash_attention_ref``, and ``kernels.ops`` picks between them by
the tensor's device.

``launches`` counts the kernel's launches in this process.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _entry():
    lib = build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:            # without them ctypes cuts pointers to 32 bits
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 5 + [i] * 6 + [ll] * 12 +
                       [i, i, ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return lib, fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(
                f"flash_attention_fwd: {name} is on {t.device}; the kernel "
                "takes CUDA tensors (CPU tensors go to kernels.ref through "
                "kernels.ops)")
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention_fwd: {name} is {t.dtype}; q, k "
                            "and v must all be float32 or all bfloat16")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"(B, H, S, D), got {tuple(t.shape)}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(
                f"flash_attention_fwd: {name} needs a contiguous last axis "
                "and rows that start on 16-byte boundaries, got strides "
                f"{t.stride()}")
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention_fwd: {hq} query heads are not a "
                         f"multiple of {k.shape[1]} kv heads")
    if d not in SUPPORTED_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_fwd: head dim {d} is not built (supported: "
            f"{SUPPORTED_HEAD_DIMS}); other head dims are an open item of "
            "ROADMAP.md (queue 2, flash attention)")
    if s == 0 or window < 0:
        raise ValueError(f"flash_attention_fwd: S={s}, window={window}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) -> (out like q, lse (B, Hq, S)).

    Any strides with a contiguous last axis: ``out`` takes q's memory layout,
    so a transposed view of the model's (B, S, H, D) tensors goes in and
    comes out without a copy.  Launches on the current stream and does not
    synchronise.
    """
    global launches
    _check(q, k, v, window)
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib, fn = _entry()
    with torch.cuda.device(q.device):      # the C side launches on the current device
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODES[q.dtype], b, hq, k.shape[1], s, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], int(causal), int(window),
                 1.0 / math.sqrt(d),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_fwd")
    launches += 1
    return out, lse
