"""Adam and its learning-rate schedules, in PyTorch (the paper uses Adam,
betas=(0.9, 0.999), no weight decay).

The counterpart of ``repro.optim.adam``.  The state mirrors the parameters
(fp32 moments m and v) plus a step counter, a host int: the source of truth
between training windows, which the state store's codec writes as it is.
Where the JAX code builds new trees and donates the old buffers to the
jitted step, the update writes parameters and moments **in place**: the same
values, without a second copy of the model and its moments on the card.

A step's numbers are computed on the device in fp32 from a 0-d step tensor,
as JAX computes them inside jit (``repro/optim/adam.py:48-61``, ``:80-94``):
the clip scale from the global gradient norm, the learning rate (the
schedule at the new step, times CheckFree's ``lr_scale``) and the bias
corrections (:func:`adam_scalars`).  So no number of a step is a host float,
and a CUDA graph can replay it.  The element-wise update runs through
``kernels.ops.adam_update``: the hand-written kernel on the card, its plain
version (``repro/optim/adam.py:79-104``'s arithmetic: global-norm clipping
before the moments, ``lr * m_hat / (sqrt(v_hat) + eps)``) on the CPU.
CheckFree's recovery zeroes a recovered stage's moments
(:func:`reset_state_subtree`, or in place on the stage slices).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch import tree as TR
from repro_torch.config import OptimizerConfig
from repro_torch.kernels import ops

Params = Any


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


def lr_schedule(cfg: OptimizerConfig, step: Union[int, torch.Tensor]
                ) -> Union[float, torch.Tensor]:
    """Warmup + {cosine, linear, constant} decay, computed in fp32.

    ``step`` is a 0-d tensor on any device (-> a 0-d fp32 tensor there) or
    an int (-> a float).
    """
    if isinstance(step, int):
        return float(lr_schedule(cfg, torch.tensor(step)))
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * \
            0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * t
    else:  # constant
        decay = torch.ones_like(step)
    return cfg.lr * warm * decay


def adam_scalars(cfg: OptimizerConfig, step: torch.Tensor,
                 lr_scale: torch.Tensor, grad_norm: torch.Tensor
                 ) -> torch.Tensor:
    """(clip scale, lr, bc1, bc2): one fp32 (4,) tensor on the device.

    ``step`` is the 0-d step being taken (already counted), ``lr_scale``
    a 0-d fp32 tensor, ``grad_norm`` the 0-d global gradient norm; the scale
    is 1 without clipping.
    """
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / (grad_norm + 1e-9), max=1.0)
    else:
        scale = torch.ones_like(grad_norm)
    b1, b2 = cfg.betas
    t = step.float()
    lr = lr_schedule(cfg, step) * lr_scale
    return torch.stack([scale, lr, 1 - torch.pow(b1, t),
                        1 - torch.pow(b2, t)]).float()


def update_options(cfg: OptimizerConfig) -> Dict[str, Any]:
    """The constants of ``ops.adam_update`` from the optimizer config."""
    return dict(betas=tuple(cfg.betas), eps=cfg.eps,
                weight_decay=cfg.weight_decay, clip=cfg.grad_clip > 0)


@torch.no_grad()
def adam_step(cfg: OptimizerConfig, params: List[torch.Tensor],
              grads: List[torch.Tensor], m: List[torch.Tensor],
              v: List[torch.Tensor], step: torch.Tensor,
              lr_scale: torch.Tensor, grad_norm: torch.Tensor
              ) -> torch.Tensor:
    """One Adam step of the leaves, in place, on device scalars: adds one to
    ``step`` (0-d int32, the steps taken), updates p, m and v through
    ``ops.adam_update`` and returns the step's (clip scale, lr, bc1, bc2).
    Reads nothing back to the host."""
    step.add_(1)
    scalars = adam_scalars(cfg, step, lr_scale, grad_norm)
    ops.adam_update(params, grads, m, v, scalars, **update_options(cfg))
    return scalars


@torch.no_grad()
def adam_update(cfg: OptimizerConfig, params: Params, grads: Params,
                state: OptState, lr_scale: float = 1.0, *,
                grad_norm: Optional[torch.Tensor] = None,
                ) -> Tuple[Params, OptState, Dict[str, Any]]:
    """One Adam step of a tree, in place, from the host state: the
    counterpart of the JAX ``adam_update``.  ``lr_scale`` carries
    CheckFree's 1.1x boost.

    ``grad_norm`` overrides the global gradient norm computed here (the JAX
    pipeline backend passes the mesh-global norm).  Returns the same
    ``params`` and moment tensors, updated, with
    ``{"grad_norm": 0-d tensor, "lr": float}``.  ``grads`` are not changed.
    """
    leaves = TR.leaves(params)
    device = leaves[0].device
    gn = global_norm(grads) if grad_norm is None else grad_norm
    step = torch.full((), state.step, dtype=torch.int32, device=device)
    ls = torch.full((), lr_scale, dtype=torch.float32, device=device)
    scalars = adam_step(cfg, leaves, TR.leaves(grads), TR.leaves(state.m),
                        TR.leaves(state.v), step, ls, gn.to(device))
    return params, OptState(state.m, state.v, state.step + 1), {
        "grad_norm": gn, "lr": float(scalars[1])}


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
