"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper runs these, and the kernel tests on the
card hold each CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) -> (out in q's dtype, lse fp32).

    The function of ``repro.kernels.ref.flash_attention_ref``, plus the
    per-row logsumexp ``lse`` (B, Hq, S) that the forward kernel writes.
    GQA: query head h reads kv head h // (Hq // Hkv).
    """
    s, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype), lse
