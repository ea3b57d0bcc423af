"""Dispatch between each kernel and its plain version, by the tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels.ref``); a CUDA tensor
takes the hand-written kernel, which launches or raises.  Any other device
raises: there is no silent fallback.  ``flash_attention`` also adapts the
model layout (B, S, H, D) to the kernel layout (B, H, S, D) as strided views,
so no copy is made on the way in or out.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import stage_merge as SM


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout (B, S, H, D) in and out; k/v may have fewer heads (GQA).

    Differentiable on both devices: on the CPU through PyTorch's autograd of
    the plain version, on CUDA through :class:`FA.FlashAttention`, whose
    backward launches the two backward kernels.
    """
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.device.type == "cpu":
        out, _ = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                         window=window)
    elif q.device.type == "cuda":
        out = FA.FlashAttention.apply(qt, kt, vt, causal, window)
    else:
        raise ValueError(f"flash_attention: no kernel and no plain version "
                         f"for tensors on {q.device}")
    return out.transpose(1, 2)


def stage_merge(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor], ca, cb,
                *, out: Optional[Sequence[torch.Tensor]] = None,
                ) -> List[torch.Tensor]:
    """``ca * x + cb * y`` (fp32 sums, x's dtype) for every leaf of a stage.

    ``ca`` and ``cb`` are floats or 0-d tensors; ``out`` (default: new
    tensors) receives the merged leaves and must not overlap the inputs.  On
    CUDA every leaf goes through one launch of the merge kernel, with the
    weights kept on the device.
    """
    xs, ys = list(xs), list(ys)
    if not xs:
        return []
    out = [torch.empty_like(x) for x in xs] if out is None else list(out)
    device = xs[0].device
    if device.type == "cpu":
        for x, y, o in zip(xs, ys, out):
            o.copy_(ref.stage_merge_ref(x, y, ca, cb))
    elif device.type == "cuda":
        w = torch.stack([torch.as_tensor(c, dtype=torch.float32, device=device)
                         .reshape(()) for c in (ca, cb)])
        SM.stage_merge(xs, ys, out, w)
    else:
        raise ValueError(f"stage_merge: no kernel and no plain version for "
                         f"tensors on {device}")
    return out
