"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper runs these, and the kernel tests on the
card hold each CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def _mask(s: int, causal: bool, window: int, device) -> torch.Tensor:
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) -> (out in q's dtype, lse fp32).

    The function of ``repro.kernels.ref.flash_attention_ref``, plus the
    per-row logsumexp ``lse`` (B, Hq, S) that the forward kernel writes.
    GQA: query head h reads kv head h // (Hq // Hkv).  Differentiable by
    PyTorch's own autograd.
    """
    s, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) / math.sqrt(d)
    logits = torch.where(_mask(s, causal, window, q.device), logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, causal: bool = True,
                            window: int = 0,
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function: (dq like q, dk like k, dv like v).

    The FlashAttention-2 formulas of ``repro/kernels/flash_attention.py``
    (module docstring), in fp32 from the forward's ``lse``:
    P = exp(s - lse) (masked -> 0), D = rowsum(dO * O),
    dV = P^T dO, dS = P (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q,
    with dK and dV summed over each kv head's group of query heads.
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    qf, dof = q.float(), do.float()
    logits = torch.einsum("bhsd,bhtd->bhst", qf * scale, kk)
    mask = _mask(s, causal, window, q.device)
    p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    delta = (dof * out.float()).sum(-1)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vv)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kk) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    dk = dk.reshape(b, hkv, g, s, d).sum(2)
    dv = dv.reshape(b, hkv, g, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def stage_merge_ref(x: torch.Tensor, y: torch.Tensor, ca, cb) -> torch.Tensor:
    """``ca * x + cb * y`` in fp32, cast to x's dtype
    (``repro.kernels.ref.stage_merge_ref``)."""
    ca = torch.as_tensor(ca, dtype=torch.float32, device=x.device)
    cb = torch.as_tensor(cb, dtype=torch.float32, device=x.device)
    return (ca * x.float() + cb * y.float()).to(x.dtype)
