"""The Mamba2 SSD chunked scan on the H100: the wrapper of ``csrc/ssd_scan.cu``.

The kernel replaces the TPU kernel ``_ssd_kernel`` of
``repro/kernels/ssd_scan.py`` and also does what the model path takes from
``repro.models.ssm.ssd_chunked``: it starts from an optional state and
returns the final one.  It works in the model layout, xb (B, T, H, P),
a (B, T, H), bmat/cmat (B, T, G, N), and takes strided views (B and C are
slices of the model's xBC tensor) without a copy.  bf16 runs on the tensor
cores, one block per 32 state rows of a head; fp32 (the card-vs-CPU
checks) on the CUDA cores.  It takes tensors that lie
on a CUDA device and nothing else: the plain versions for CPU tensors are in
``kernels.ref``, and ``kernels.ops`` picks between them by the tensor's
device.  Forward only, as the TPU kernel: ``kernels.ops.ssd_scan`` refuses
inputs that require a gradient.

``launches`` counts the kernel's launches in this process.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_CHUNK, MAX_P, MAX_N = 64, 64, 128     # csrc/ssd_scan.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# without argtypes ctypes passes each pointer as a 32-bit int and cuts it
_ARGTYPES = [_P] * 7 + [_I] * 8 + [_LL] * 15 + [_P]


def _entry():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _check(xb: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
           cmat: torch.Tensor, chunk: int,
           init_state: Optional[torch.Tensor]) -> None:
    named = [("xb", xb), ("a", a), ("bmat", bmat), ("cmat", cmat)]
    if init_state is not None:
        named.append(("init_state", init_state))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(
                f"ssd_scan: {name} is on {t.device}; the kernel takes CUDA "
                "tensors (CPU tensors go to kernels.ref through kernels.ops)")
        if t.device != xb.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, xb on "
                             f"{xb.device}")
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name} needs a contiguous last axis, "
                             f"got strides {t.stride()}")
    if xb.dtype not in _DTYPE_CODES or bmat.dtype != xb.dtype \
            or cmat.dtype != xb.dtype:
        raise TypeError(f"ssd_scan: xb {xb.dtype}, bmat {bmat.dtype}, cmat "
                        f"{cmat.dtype}; all float32 or all bfloat16")
    if a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: a is {a.dtype}; the log decay is float32")
    if xb.dim() != 4 or a.dim() != 3 or bmat.dim() != 4:
        raise ValueError(f"ssd_scan: xb {tuple(xb.shape)} must be "
                         f"(B, T, H, P), a {tuple(a.shape)} (B, T, H), bmat "
                         f"{tuple(bmat.shape)} (B, T, G, N)")
    b, t, h, p = xb.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if a.shape != (b, t, h) or bmat.shape[:2] != (b, t) \
            or cmat.shape != bmat.shape:
        raise ValueError(f"ssd_scan: xb {tuple(xb.shape)}, a {tuple(a.shape)}, "
                         f"bmat {tuple(bmat.shape)}, cmat {tuple(cmat.shape)} "
                         "do not match")
    if g == 0 or h % g:
        raise ValueError(f"ssd_scan: {h} heads are not a multiple of {g} "
                         "groups")
    if t == 0 or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: T={t}, chunk={chunk} (1..{MAX_CHUNK})")
    if p % 4 or not 4 <= p <= MAX_P or n % 4 or not 4 <= n <= MAX_N:
        raise NotImplementedError(
            f"ssd_scan: P={p}, N={n}; the kernel is built for multiples of 4 "
            f"up to P {MAX_P} and N {MAX_N}")
    if init_state is not None and (
            init_state.shape != (b, h, p, n)
            or init_state.dtype != torch.float32
            or not init_state.is_contiguous()):
        raise ValueError(f"ssd_scan: init_state must be a contiguous fp32 "
                         f"{(b, h, p, n)}, got {init_state.dtype} "
                         f"{tuple(init_state.shape)}")


def ssd_scan(xb: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, H, P) in xb's dtype, final state (B, H, P, N) fp32).

    xb (B, T, H, P) and bmat/cmat (B, T, G, N) are float32 or bfloat16, a
    (B, T, H) is float32, init_state (B, H, P, N) a contiguous float32 or
    None for zeros; any strides with a contiguous last axis.  A ragged last
    chunk is masked.  Launches on the current stream and does not
    synchronise.  No autograd.
    """
    global launches
    _check(xb, a, bmat, cmat, chunk, init_state)
    b, t, h, p = xb.shape
    g, n = bmat.shape[2], bmat.shape[3]
    y = torch.empty((b, t, h, p), dtype=xb.dtype, device=xb.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=xb.device)
    lib, fn = _entry()
    with torch.cuda.device(xb.device):   # the C side launches on the current device
        err = fn(xb.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                 None if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), final.data_ptr(), _DTYPE_CODES[xb.dtype],
                 b, t, h, g, p, n, chunk,
                 *xb.stride()[:3], *a.stride(), *bmat.stride()[:3],
                 *cmat.stride()[:3], *y.stride()[:3],
                 torch.cuda.current_stream(xb.device).cuda_stream)
    build.check(lib, err, "ssd_scan")
    launches += 1
    return y, final
