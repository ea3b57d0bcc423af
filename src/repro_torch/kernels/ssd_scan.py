"""The Mamba2 SSD chunked scan on the H100: the wrappers of ``csrc/ssd_scan.cu``
and ``csrc/ssd_scan_bwd.cu``, and the autograd Function over them.

The forward kernel replaces the TPU kernel ``_ssd_kernel`` of
``repro/kernels/ssd_scan.py`` and also does what the model path takes from
``repro.models.ssm.ssd_chunked``: it starts from an optional state and
returns the final one.  It works in the model layout, xb (B, T, H, P),
a (B, T, H), bmat/cmat (B, T, G, N), and takes strided views (B and C are
slices of the model's xBC tensor) without a copy.  bf16 runs on the tensor
cores, one block per 32 state rows of a head; fp32 (the card-vs-CPU
checks) on the CUDA cores.

The backward kernel has no TPU counterpart (the TPU kernel has no VJP; JAX
trains through autodiff of ``ssd_chunked``): it computes
``ref.ssd_chunked_bwd_ref``, recomputing the chunks' entry states instead of
saving them, in a fixed order of sums (no atomics), so that a CUDA graph
replays it bit for bit.  bf16 runs on the tensor cores, one block per 32
state rows of a head, leaving fp32 partials of dB, dC and d cs per block
that a second pass sums; fp32 (the card-vs-CPU checks) on the CUDA cores,
one block a head.  :class:`SSDScan` is the autograd Function: its
forward launches the forward kernel and saves its inputs, its backward
launches the backward kernel.

Both take tensors that lie on a CUDA device and nothing else: the plain
versions for CPU tensors are in ``kernels.ref``, and ``kernels.ops`` picks
between them by the tensor's device; on meta tensors (the dry-run) both
launch nothing, return empty outputs of the kernels' shapes and credit the
kernels' counts (``kernels.cost``) to the open tally.  ``launches`` and
``launches_bwd`` count each kernel's launches in this process (meta calls
are not launches), ``launches_bwd_path`` the
backward's by the walk kernel it ran (``bf16``, the tensor cores; ``f32``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost

MAX_CHUNK, MAX_P, MAX_N = 64, 64, 128     # csrc/ssd_scan.cu
P_BLK = 32                                # the bf16 backward's state rows a block
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_bwd = 0
launches_bwd_path = {"bf16": 0, "f32": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# without argtypes ctypes passes each pointer as a 32-bit int and cuts it
_ARGTYPES = {"ssd_scan": [_P] * 7 + [_I] * 8 + [_LL] * 15 + [_P],
             "ssd_scan_bwd": [_P] * 16 + [_I] * 8 + [_LL] * 15 + [_P]}


def _entry(name: str = "ssd_scan"):
    lib = build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _check(xb: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
           cmat: torch.Tensor, chunk: int,
           init_state: Optional[torch.Tensor], what: str = "ssd_scan",
           **more: Optional[torch.Tensor]) -> None:
    named = [("xb", xb), ("a", a), ("bmat", bmat), ("cmat", cmat)]
    named += [(k, t) for k, t in (("init_state", init_state), *more.items())
              if t is not None]
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(
                f"{what}: {name} is on {t.device}; the kernel takes CUDA "
                "tensors (CPU tensors go to kernels.ref through kernels.ops)")
        if t.device != xb.device:
            raise ValueError(f"{what}: {name} is on {t.device}, xb on "
                             f"{xb.device}")
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last axis, "
                             f"got strides {t.stride()}")
    if xb.dtype not in _DTYPE_CODES or bmat.dtype != xb.dtype \
            or cmat.dtype != xb.dtype:
        raise TypeError(f"{what}: xb {xb.dtype}, bmat {bmat.dtype}, cmat "
                        f"{cmat.dtype}; all float32 or all bfloat16")
    if a.dtype != torch.float32:
        raise TypeError(f"{what}: a is {a.dtype}; the log decay is float32")
    if xb.dim() != 4 or a.dim() != 3 or bmat.dim() != 4:
        raise ValueError(f"{what}: xb {tuple(xb.shape)} must be "
                         f"(B, T, H, P), a {tuple(a.shape)} (B, T, H), bmat "
                         f"{tuple(bmat.shape)} (B, T, G, N)")
    b, t, h, p = xb.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if a.shape != (b, t, h) or bmat.shape[:2] != (b, t) \
            or cmat.shape != bmat.shape:
        raise ValueError(f"{what}: xb {tuple(xb.shape)}, a {tuple(a.shape)}, "
                         f"bmat {tuple(bmat.shape)}, cmat {tuple(cmat.shape)} "
                         "do not match")
    if g == 0 or h % g:
        raise ValueError(f"{what}: {h} heads are not a multiple of {g} "
                         "groups")
    if t == 0 or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{what}: T={t}, chunk={chunk} (1..{MAX_CHUNK})")
    if p % 4 or not 4 <= p <= MAX_P or n % 4 or not 4 <= n <= MAX_N:
        raise NotImplementedError(
            f"{what}: P={p}, N={n}; the kernel is built for multiples of 4 "
            f"up to P {MAX_P} and N {MAX_N}")
    if init_state is not None and (
            init_state.shape != (b, h, p, n)
            or init_state.dtype != torch.float32
            or not init_state.is_contiguous()):
        raise ValueError(f"{what}: init_state must be a contiguous fp32 "
                         f"{(b, h, p, n)}, got {init_state.dtype} "
                         f"{tuple(init_state.shape)}")
    dy, dfinal = more.get("dy"), more.get("dfinal")
    if dy is not None and (dy.shape != xb.shape or dy.dtype != xb.dtype):
        raise ValueError(f"{what}: dy must be {xb.dtype} {tuple(xb.shape)}, "
                         f"got {dy.dtype} {tuple(dy.shape)}")
    if dfinal is not None and (
            dfinal.shape != (b, h, p, n) or dfinal.dtype != torch.float32
            or not dfinal.is_contiguous()):
        raise ValueError(f"{what}: dfinal must be a contiguous fp32 "
                         f"{(b, h, p, n)}, got {dfinal.dtype} "
                         f"{tuple(dfinal.shape)}")


def ssd_scan(xb: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, H, P) in xb's dtype, final state (B, H, P, N) fp32).

    xb (B, T, H, P) and bmat/cmat (B, T, G, N) are float32 or bfloat16, a
    (B, T, H) is float32, init_state (B, H, P, N) a contiguous float32 or
    None for zeros; any strides with a contiguous last axis.  A ragged last
    chunk is masked.  Launches on the current stream and does not
    synchronise.  No autograd: :class:`SSDScan` carries the gradient.
    """
    global launches
    b, t, h, p = xb.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if xb.is_meta:
        cost.credit("ssd_scan", cost.ssd_fwd(b, t, h, p, g, n, chunk,
                                             itemsize=xb.element_size()))
        return (xb.new_empty((b, t, h, p)),
                xb.new_empty((b, h, p, n), dtype=torch.float32))
    _check(xb, a, bmat, cmat, chunk, init_state)
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


def ssd_scan_bwd(xb: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, dy: torch.Tensor, *, chunk: int,
                 init_state: Optional[torch.Tensor] = None,
                 dfinal: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, ...]:
    """(dxb like xb, da (B, T, H) fp32, dbmat like bmat, dcmat like cmat,
    dinit (B, H, P, N) fp32 or None when ``init_state`` is None).

    The forward's inputs as :func:`ssd_scan` takes them; dy (B, T, H, P) in
    xb's dtype with a contiguous last axis, dfinal (B, H, P, N) contiguous
    fp32 or None for zeros.  The outputs are contiguous.  Scratch (the
    chunks' entry states; fp32 dB and dC per head and, for bf16, per block
    of 32 state rows, with that block's d cs) comes from the caching
    allocator for the call.  Launches on the current stream and does not
    synchronise.
    """
    global launches_bwd
    b, t, h, p = xb.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if xb.is_meta:
        cost.credit("ssd_scan_bwd", cost.ssd_bwd(b, t, h, p, g, n, chunk,
                                                 itemsize=xb.element_size()))
        return (xb.new_empty(xb.shape), a.new_empty(a.shape),
                bmat.new_empty(bmat.shape), cmat.new_empty(cmat.shape),
                None if init_state is None else init_state.new_empty(
                    init_state.shape))
    _check(xb, a, bmat, cmat, chunk, init_state, "ssd_scan_bwd", dy=dy,
           dfinal=dfinal)
    nc = -(-t // chunk)
    dev = xb.device
    dx = torch.empty((b, t, h, p), dtype=xb.dtype, device=dev)
    da = torch.empty((b, t, h), dtype=torch.float32, device=dev)
    db = torch.empty((b, t, g, n), dtype=bmat.dtype, device=dev)
    dc = torch.empty((b, t, g, n), dtype=cmat.dtype, device=dev)
    dinit = None if init_state is None else torch.empty(
        (b, h, p, n), dtype=torch.float32, device=dev)
    path = "bf16" if xb.dtype == torch.bfloat16 else "f32"
    if path == "bf16":
        # per 32-row block and chunk, bf16 hi and lo tiles of the entry
        # state, N padded to 64 or 128: 4 bytes an element
        nblk = -(-p // P_BLK)
        states = torch.empty((b, h, nblk, nc, P_BLK, 64 if n <= 64 else 128),
                             dtype=torch.float32, device=dev)
        dcs = torch.empty((b, t, h, nblk), dtype=torch.float32, device=dev)
    else:
        nblk = 1
        states = torch.empty((b, h, nc, p, n), dtype=torch.float32,
                             device=dev)
        dcs = None
    dbh = torch.empty((b, t, h, nblk, n), dtype=torch.float32, device=dev)
    dch = torch.empty_like(dbh)

    def ptr(v):
        return None if v is None else v.data_ptr()

    lib, fn = _entry("ssd_scan_bwd")
    with torch.cuda.device(dev):
        err = fn(xb.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                 dy.data_ptr(), ptr(init_state), ptr(dfinal), dx.data_ptr(),
                 da.data_ptr(), db.data_ptr(), dc.data_ptr(), ptr(dinit),
                 states.data_ptr(), dbh.data_ptr(), dch.data_ptr(), ptr(dcs),
                 _DTYPE_CODES[xb.dtype], b, t, h, g, p, n, chunk,
                 *xb.stride()[:3], *a.stride(), *bmat.stride()[:3],
                 *cmat.stride()[:3], *dy.stride()[:3],
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ssd_scan_bwd")
    launches_bwd += 1
    launches_bwd_path[path] += 1
    return dx, da, db, dc, dinit


class SSDScan(torch.autograd.Function):
    """Model layout: (xb, a, bmat, cmat, chunk, init_state) -> (y, final
    state); the gradients of xb, a, bmat, cmat and init_state come from
    :func:`ssd_scan_bwd`.  An unused output's gradient arrives as None and
    counts as zeros, without a tensor of zeros."""

    @staticmethod
    def forward(ctx, xb, a, bmat, cmat, chunk: int, init_state):
        ctx.set_materialize_grads(False)
        y, final = ssd_scan(xb, a, bmat, cmat, chunk=chunk,
                            init_state=init_state)
        ctx.save_for_backward(xb, a, bmat, cmat, init_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        xb, a, bmat, cmat, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xb)
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.float().contiguous()
        dx, da, db, dc, dinit = ssd_scan_bwd(
            xb, a, bmat, cmat, dy, chunk=ctx.chunk, init_state=init_state,
            dfinal=dfinal)
        return dx, da, db, dc, None, dinit
