"""Adam and its learning-rate schedules, in PyTorch (the paper uses Adam,
betas=(0.9, 0.999), no weight decay).

The counterpart of ``repro.optim.adam``.  The state mirrors the parameters
(fp32 moments m and v) plus a step counter.  Where the JAX code builds new
trees and donates the old buffers to the jitted step, :func:`adam_update`
updates parameters and moments **in place** under ``torch.no_grad()``: the
same values, without a second copy of the model and its moments on the card.
The step counter is a host int, so the learning rate is a host float and the
update needs no copy from the device.  The arithmetic follows
``repro/optim/adam.py:87-102``: global-norm clipping before the moments,
``lr * m_hat / (sqrt(v_hat) + eps)``, bias corrections and the learning rate
in fp32.  CheckFree's recovery zeroes a recovered stage's moments
(:func:`reset_state_subtree`, or in place on the stage slices).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.config import OptimizerConfig

Params = Any
_F32 = np.float32


class OptState(NamedTuple):
    m: Params
    v: Params
    step: int


def init_adam(params: Params) -> OptState:
    """Zero fp32 moments beside every parameter, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(m=TR.map(zeros, params), v=TR.map(zeros, params), step=0)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared fp32 entries (a 0-d tensor)."""
    sq = [x.float().square().sum() for x in TR.leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def lr_schedule(cfg: OptimizerConfig, step: int) -> float:
    """Warmup + {cosine, linear, constant} decay, computed in fp32."""
    step = _F32(step)
    warm = min(step / _F32(max(cfg.warmup_steps, 1)), _F32(1.0))
    t = (step - _F32(cfg.warmup_steps)) / _F32(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    t = _F32(min(max(t, _F32(0.0)), _F32(1.0)))
    if cfg.schedule == "cosine":
        decay = _F32(cfg.min_lr_ratio) + _F32(1 - cfg.min_lr_ratio) * \
            _F32(0.5) * (_F32(1) + _F32(np.cos(_F32(math.pi) * t)))
    elif cfg.schedule == "linear":
        decay = _F32(1.0) - _F32(1 - cfg.min_lr_ratio) * t
    else:  # constant
        decay = _F32(1.0)
    return float(_F32(cfg.lr) * warm * decay)


@torch.no_grad()
def adam_update(cfg: OptimizerConfig, params: Params, grads: Params,
                state: OptState, lr_scale: float = 1.0, *,
                grad_norm: Optional[torch.Tensor] = None,
                ) -> Tuple[Params, OptState, Dict[str, Any]]:
    """One Adam step, in place.  ``lr_scale`` carries CheckFree's 1.1x boost.

    ``grad_norm`` overrides the global gradient norm computed here (the JAX
    pipeline backend passes the mesh-global norm).  Returns the same
    ``params`` and moment tensors, updated, with
    ``{"grad_norm": 0-d tensor, "lr": float}``.  ``grads`` are not changed.
    """
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    step = state.step + 1
    b1, b2 = cfg.betas
    lr = float(_F32(lr_schedule(cfg, step)) * _F32(lr_scale))
    bc1 = float(_F32(1) - _F32(b1) ** _F32(step))
    bc2 = float(_F32(1) - _F32(b2) ** _F32(step))
    for p, g, m, v in zip(TR.leaves(params), TR.leaves(grads),
                          TR.leaves(state.m), TR.leaves(state.v)):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g.square(), alpha=1 - b2)
        delta = (m / bc1).mul_(lr).div_((v / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay > 0:
            delta.add_(p.float(), alpha=lr * cfg.weight_decay)
        p.sub_(delta.to(p.dtype))
    return params, OptState(state.m, state.v, step), {"grad_norm": gn, "lr": lr}


@torch.no_grad()
def reset_state_subtree(state: OptState, mask_fn) -> OptState:
    """Zero the Adam moments wherever ``mask_fn(path, leaf)`` says so, in place.

    ``path`` is the tuple of dict keys down to the leaf; ``mask_fn`` returns
    a bool or a bool tensor broadcastable to the leaf.
    """
    for tree in (state.m, state.v):
        for path, leaf in TR.leaves_with_path(tree):
            mask = mask_fn(path, leaf)
            if isinstance(mask, torch.Tensor):
                leaf.masked_fill_(mask.to(torch.bool), 0.0)
            elif mask:
                leaf.zero_()
    return state
