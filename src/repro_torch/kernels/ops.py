"""Dispatch between each kernel and its plain version, by the tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels.ref``); a CUDA tensor
takes the hand-written kernel, which launches or raises.  Any other device
raises: there is no silent fallback.  ``flash_attention`` also adapts the
model layout (B, S, H, D) to the kernel layout (B, H, S, D) as strided views,
so no copy is made on the way in or out.  ``ssd_scan`` is differentiable on
both devices: on the card through :class:`SSD.SSDScan`, whose backward is a
hand-written kernel too (the TPU kernel has none; JAX trains through
autodiff of ``ssd_chunked``).  ``adam_sumsq`` and
``adam_update`` have no TPU counterpart: they are the port's counterpart of
XLA's fusion of the optimizer step.  :func:`launch_counts` reads every
wrapper's count of launches.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import adam as AD
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels import stage_merge as SM


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout (B, S, H, D) in and out; k/v may have fewer heads (GQA)
    and another length than q (cross-attention: ``causal=False, window=0``
    only, on both devices).

    Differentiable on both devices: on the CPU through PyTorch's autograd of
    the plain version, on CUDA through :class:`FA.FlashAttention`, whose
    backward launches the two backward kernels.
    """
    if k.shape[1] != q.shape[1] and (causal or window):
        raise ValueError(f"flash_attention: {q.shape[1]} queries over "
                         f"{k.shape[1]} keys take no causal or window mask")
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


def ssd_scan(xb: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan, model layout -> (y like xb, final state fp32).

    xb (B, T, H, P) dt-weighted inputs, a (B, T, H) fp32 log decay,
    bmat/cmat (B, T, G, N), init_state optional (B, H, P, N).  On the CPU the
    plain ``ref.ssd_chunked`` (differentiable by PyTorch's autograd); on CUDA
    :class:`SSD.SSDScan`: the forward kernel, and the backward kernel for
    the gradients of xb, a, bmat, cmat and init_state.
    """
    if xb.device.type == "cpu":
        return ref.ssd_chunked(xb, a, bmat, cmat, chunk, init_state)
    if xb.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel and no plain version for "
                         f"tensors on {xb.device}")
    if init_state is not None:
        init_state = init_state.float().contiguous()
    return SSD.SSDScan.apply(xb, a, bmat, cmat, chunk, init_state)


def adam_sumsq(grads: Sequence[torch.Tensor], tower: Sequence[bool],
               layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-layer sums of squares (layers,), total), fp32, of every gradient
    leaf: ``tower[i]`` marks a leaf of the stacked tower, whose ``layers``
    rows are summed apart (the stages' omegas); the total covers every leaf
    (the global norm).  On CUDA one pass of the kernel over every leaf."""
    grads = list(grads)
    device = grads[0].device
    if device.type == "cpu":
        return ref.adam_sumsq_ref(grads, tower, layers)
    if device.type == "cuda":
        return AD.adam_sumsq(grads, tower, layers)
    raise ValueError(f"adam_sumsq: no kernel and no plain version for "
                     f"tensors on {device}")


def adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
                scalars: torch.Tensor, *, betas: Tuple[float, float],
                eps: float, weight_decay: float, clip: bool) -> None:
    """One Adam step of every fp32 leaf, in place: ``scalars`` is (clip
    scale, lr, bc1, bc2) on the leaves' device.  On CUDA one launch of the
    kernel for every leaf."""
    params = list(params)
    device = params[0].device
    kw = dict(betas=betas, eps=eps, weight_decay=weight_decay, clip=clip)
    if device.type == "cpu":
        ref.adam_update_ref(params, grads, m, v, scalars, **kw)
    elif device.type == "cuda":
        AD.adam_update(params, grads, m, v, scalars, **kw)
    else:
        raise ValueError(f"adam_update: no kernel and no plain version for "
                         f"tensors on {device}")


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches in this process, by the wrappers' counts."""
    return {"flash_attention_fwd": FA.launches,
            "flash_attention_bwd_dq": FA.launches_dq,
            "flash_attention_bwd_dkv": FA.launches_dkv,
            "stage_merge": SM.launches, "ssd_scan": SSD.launches,
            "ssd_scan_bwd": SSD.launches_bwd,
            "adam_sumsq": AD.launches_sumsq,
            "adam_update": AD.launches_update}
