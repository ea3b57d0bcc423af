"""Dispatch between each kernel and its plain version, by the tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels.ref``); a CUDA tensor
takes the hand-written kernel, which launches or raises.  Any other device
raises: there is no silent fallback.  The wrappers also adapt the model
layout (B, S, H, D) to the kernel layout (B, H, S, D) as strided views, so
no copy is made on the way in or out.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout (B, S, H, D) in and out; k/v may have fewer heads (GQA)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.device.type == "cpu":
        out, _ = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                         window=window)
    elif q.device.type == "cuda":
        out, _ = FA.flash_attention_fwd(qt, kt, vt, causal=causal,
                                        window=window)
    else:
        raise ValueError(f"flash_attention: no kernel and no plain version "
                         f"for tensors on {q.device}")
    return out.transpose(1, 2)
