"""Adam on the H100: the wrappers of ``csrc/adam.cu``.

Two kernels with no TPU counterpart (in the JAX package XLA fuses the
optimizer inside the jitted step): :func:`adam_sumsq` gives, in one pass
over the gradients, the sum of squares of each layer of the stacked tower
and of every leaf together; :func:`adam_update` updates (p, m, v) of every
leaf in one pass, in place, reading the clip scale, lr and bias corrections
from a device tensor.  Both take CUDA tensors only: the plain versions for
CPU tensors are ``kernels.ref.adam_sumsq_ref`` and ``adam_update_ref``, and
``kernels.ops`` picks between them by the tensor's device.

``launches_sumsq`` and ``launches_update`` count the kernels' launches in
this process (a CUDA graph's capture records one; its replays run it again
without passing here).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build

MAX_LEAVES = 64                       # csrc/adam.cu's table size
SUMSQ_CHUNK = 16384                   # csrc/adam.cu's CHUNK

launches_sumsq = 0
launches_update = 0


def _entry(name: str, argtypes: list):
    lib = build.load("adam")
    fn = getattr(lib, name)
    if fn.argtypes is None:            # without them ctypes cuts pointers to 32 bits
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _check(what: str, groups: Sequence[Sequence[torch.Tensor]]) -> None:
    """Every leaf of every group: fp32, contiguous, on the first leaf's CUDA
    device, one shape across the groups; at most MAX_LEAVES leaves."""
    count = len(groups[0])
    if not count or any(len(g) != count for g in groups):
        raise ValueError(f"{what}: groups of {[len(g) for g in groups]} leaves")
    if count > MAX_LEAVES:
        raise ValueError(f"{what}: {count} leaves, the kernel's table holds "
                         f"{MAX_LEAVES}")
    device = groups[0][0].device
    if device.type != "cuda":
        raise ValueError(f"{what}: tensors on {device}; the kernel takes CUDA "
                         "tensors (CPU tensors go to kernels.ref through "
                         "kernels.ops)")
    for i in range(count):
        shape = groups[0][i].shape
        for t in (g[i] for g in groups):
            if t.device != device or t.dtype != torch.float32:
                raise ValueError(f"{what}: leaf {i} is {t.dtype} on "
                                 f"{t.device}; the kernel takes fp32 on "
                                 f"{device}")
            if not t.is_contiguous() or t.shape != shape:
                raise ValueError(f"{what}: leaf {i} is not contiguous or its "
                                 f"shapes differ ({tuple(t.shape)}, "
                                 f"{tuple(shape)})")


def adam_sumsq(grads: Sequence[torch.Tensor], tower: Sequence[bool],
               layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-layer sums of squares (layers,), total) as fp32 on the device.

    ``tower[i]`` marks a leaf of the stacked tower: its ``layers`` rows along
    axis 0 are summed apart, and the per-layer sums add those rows over the
    tower's leaves.  The total sums every leaf.  Two launches on the current
    stream (the partials, then one block for the rest); no synchronise.
    """
    global launches_sumsq
    grads = list(grads)
    _check("adam_sumsq", [grads])
    if len(tower) != len(grads):
        raise ValueError(f"adam_sumsq: {len(tower)} tower flags for "
                         f"{len(grads)} leaves")
    rows, blocks = [], 0
    for g, t in zip(grads, tower):
        if t and (g.dim() == 0 or g.shape[0] != layers):
            raise ValueError(f"adam_sumsq: a tower leaf of shape "
                             f"{tuple(g.shape)} has no {layers} layers")
        r = layers if t else 1
        rows.append(r)
        blocks += r * -(-(g.numel() // r) // SUMSQ_CHUNK)
    device = grads[0].device
    scratch = torch.empty(blocks + sum(rows), dtype=torch.float64,
                          device=device)
    out = torch.empty(layers + 1, dtype=torch.float32, device=device)
    table = []
    for g, r, t in zip(grads, rows, tower):
        table += [g.data_ptr(), g.numel(), r, int(bool(t))]
    table = (ctypes.c_longlong * len(table))(*table)
    lib, fn = _entry("adam_sumsq", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(table), len(grads), layers,
                 scratch.data_ptr(), scratch.numel(), out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, err, "adam_sumsq")
    launches_sumsq += 1
    return out[:layers], out[layers]


def adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
                scalars: torch.Tensor, *, betas: Tuple[float, float],
                eps: float, weight_decay: float, clip: bool) -> None:
    """One Adam step of every leaf, in place, one launch.

    ``scalars`` is a contiguous fp32 (clip scale, lr, bc1, bc2) on the
    device; the scale is used only with ``clip``.  Launches on the current
    stream and does not synchronise.
    """
    global launches_update
    params, grads, m, v = list(params), list(grads), list(m), list(v)
    _check("adam_update", [params, grads, m, v])
    device = params[0].device
    if (scalars.device != device or scalars.dtype != torch.float32
            or scalars.numel() != 4 or not scalars.is_contiguous()):
        raise ValueError(f"adam_update: scalars must be a contiguous fp32 "
                         f"(scale, lr, bc1, bc2) on {device}, got "
                         f"{scalars.dtype} {tuple(scalars.shape)} on "
                         f"{scalars.device}")
    # p, m and v are written in place: no two leaves may share memory
    spans = sorted((t.data_ptr(), t.data_ptr() + 4 * t.numel())
                   for t in (*params, *grads, *m, *v) if t.numel())
    if any(b > a for (_, b), (a, _) in zip(spans, spans[1:])):
        raise ValueError("adam_update: two leaves overlap")
    table = []
    for p, g, mm, vv in zip(params, grads, m, v):
        table += [p.data_ptr(), g.data_ptr(), mm.data_ptr(), vv.data_ptr(),
                  p.numel()]
    table = (ctypes.c_longlong * len(table))(*table)
    b1, b2 = betas
    lib, fn = _entry("adam_update", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(table), len(params), scalars.data_ptr(),
                 b1, b2, 1 - b1, 1 - b2, eps, weight_decay, int(bool(clip)),
                 torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, err, "adam_update")
    launches_update += 1
