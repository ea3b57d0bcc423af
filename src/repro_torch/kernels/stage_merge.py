"""CheckFree stage merge on the H100: the wrapper of ``csrc/stage_merge.cu``.

The kernel replaces the TPU kernel ``_merge_kernel`` of
``repro/kernels/stage_merge.py``: ``out = ca * x + cb * y`` in fp32, cast to
x's dtype.  Where the JAX code launches it once per leaf, this wrapper merges
every leaf of a stage in one launch, writing into the given output tensors
(the failed stage's slices of the tower).  It takes CUDA tensors only: the
plain version for CPU tensors is ``kernels.ref.stage_merge_ref``, and
``kernels.ops.stage_merge`` picks between them by the tensor's device.

``launches`` counts the kernel's launches in this process.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

MAX_LEAVES = 32                       # csrc/stage_merge.cu's table size
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _entry():
    lib = build.load("stage_merge")
    fn = lib.stage_merge
    if fn.argtypes is None:            # without them ctypes cuts pointers to 32 bits
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _span(t: torch.Tensor):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _check(xs, ys, outs, w) -> None:
    if not (len(xs) == len(ys) == len(outs)) or not xs:
        raise ValueError(f"stage_merge: {len(xs)} x, {len(ys)} y and "
                         f"{len(outs)} out leaves")
    if len(xs) > MAX_LEAVES:
        raise ValueError(f"stage_merge: {len(xs)} leaves, the kernel's table "
                         f"holds {MAX_LEAVES}")
    device = xs[0].device
    if device.type != "cuda":
        raise ValueError(f"stage_merge: tensors on {device}; the kernel takes "
                         "CUDA tensors (CPU tensors go to kernels.ref through "
                         "kernels.ops)")
    if (w.device != device or w.dtype != torch.float32 or w.numel() != 2
            or not w.is_contiguous()):
        raise ValueError(f"stage_merge: weights must be a contiguous fp32 "
                         f"(ca, cb) on {device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    dtype = xs[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"stage_merge: {dtype}; the kernel takes float32 or "
                        "bfloat16")
    written = []
    for i, (x, y, o) in enumerate(zip(xs, ys, outs)):
        for name, t in (("x", x), ("y", y), ("out", o)):
            if t.device != device or t.dtype != dtype:
                raise ValueError(f"stage_merge: leaf {i} {name} is {t.dtype} "
                                 f"on {t.device}, leaf 0 x {dtype} on {device}")
            if not t.is_contiguous():
                raise ValueError(f"stage_merge: leaf {i} {name} is not "
                                 "contiguous")
        if not (x.shape == y.shape == o.shape):
            raise ValueError(f"stage_merge: leaf {i} shapes {tuple(x.shape)}, "
                             f"{tuple(y.shape)}, {tuple(o.shape)}")
        written.append(_span(o))
    # the merged values are written in place: no output may overlap an input
    # or another output, or a block could read what another already wrote
    for i, (lo, hi) in enumerate(written):
        for t in (*xs, *ys):
            a, b = _span(t)
            if a < hi and lo < b and t.numel():
                raise ValueError(f"stage_merge: out leaf {i} overlaps an input")
        for j, (a, b) in enumerate(written[:i]):
            if a < hi and lo < b:
                raise ValueError(f"stage_merge: out leaves {j} and {i} overlap")


def stage_merge(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor],
                outs: Sequence[torch.Tensor], w: torch.Tensor) -> None:
    """``outs[i] = w[0] * xs[i] + w[1] * ys[i]`` for every leaf, one launch.

    ``w`` is a contiguous fp32 (ca, cb) on the device.  Launches on the
    current stream and does not synchronise.
    """
    global launches
    _check(xs, ys, outs, w)
    rows = []
    for x, y, o in zip(xs, ys, outs):
        rows += [x.data_ptr(), y.data_ptr(), o.data_ptr(), x.numel()]
    table = (ctypes.c_longlong * len(rows))(*rows)
    device = xs[0].device
    lib, fn = _entry()
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(table), len(xs), w.data_ptr(),
                 _DTYPE_CODES[xs[0].dtype],
                 torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, err, "stage_merge")
    launches += 1
