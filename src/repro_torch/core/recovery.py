"""CheckFree recovery (paper Algorithm 1) and the ablation reinits.

The counterpart of ``repro.core.recovery``.  The failed stage ``i`` is
replaced by

    W_i <- (omega_{i-1} W_{i-1} + omega_{i+1} W_{i+1}) / (omega_{i-1}+omega_{i+1})

with ``omega_j = ||grad W_j||^2`` (CheckFree), or by uniform averaging,
copying or a random reinit (the Fig. 2 ablation).  Edge stages take the
CheckFree+ twin-copy path.

Where the JAX functions return a new tree, these write the recovered stage
**in place** into its slice of the tower and return the same ``params``.
Every merge goes through ``kernels.ops.stage_merge``: the plain version for
CPU tensors, one launch of the CUDA merge kernel per stage on the card,
writing straight into the failed stage's slice.  The weights stay on the
device: a merge copies nothing to the host.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch import tree as TR
from repro_torch.core.stages import StagePartition
from repro_torch.kernels import ops

Params = Dict[str, Any]
Weight = Union[float, torch.Tensor]


def _merge_trees(a: Params, b: Params, wa: Weight, wb: Weight, *,
                 out: Params) -> Params:
    """(wa*a + wb*b) / (wa+wb), elementwise over the stage tree, into
    ``out`` (the failed stage's slice of the tower)."""
    denom = wa + wb + 1e-30
    ca = wa / denom
    cb = wb / denom
    ops.stage_merge(TR.leaves(a), TR.leaves(b), ca, cb, out=TR.leaves(out))
    return out


def _align_layers(stage: Params, n: int, side: str) -> Params:
    """Fit a neighbour's stage slice to ``n`` layers for the merge.

    The merge pairs each lost layer with the neighbour layer nearest the
    shared stage boundary: the last ``n`` layers of the previous stage, the
    first ``n`` of the next, repeating the boundary layer when the neighbour
    is smaller.  Uniform layouts pass through untouched.
    """
    def pick(x):
        m = x.shape[0]
        if m == n:
            return x
        if side == "prev":
            idx = torch.clamp(torch.arange(m - n, m, device=x.device), 0, m - 1)
        else:
            idx = torch.clamp(torch.arange(n, device=x.device), 0, m - 1)
        return x[idx]
    return TR.map(pick, stage)


@torch.no_grad()
def recover_stage(params: Params, part: StagePartition, failed: int,
                  omegas: torch.Tensor, *, strategy: str = "grad_norm",
                  generator: Optional[torch.Generator] = None) -> Params:
    """Reinitialize stage ``failed`` (0-based within the tower), in place.

    strategy:
      grad_norm  — Alg. 1 weighted average (CheckFree)
      uniform    — plain average of the two neighbours
      copy_prev  — copy the previous stage (layer-stacking baseline)
      random     — 0.02 * N(0, 1) from ``generator`` (worst baseline in
                   Fig. 2; its draws differ from JAX's for the same seed)
      twin_copy  — CheckFree+ edge-stage path: copy the swap-twin
    """
    k = part.num_stages
    first, last = failed == 0, failed == k - 1

    if strategy == "random":
        assert generator is not None, "random reinit needs a generator"
        stage = part.get_stage(params, failed)
        for x in TR.leaves(stage):
            noise = torch.randn(x.shape, generator=generator,
                                dtype=torch.float32, device=x.device)
            x.copy_(noise.mul_(0.02))
        return params

    if strategy == "twin_copy" or ((first or last) and
                                   strategy in ("grad_norm", "uniform")):
        # CheckFree+ edge recovery: S1 <- S2 (swap-trained twin), SK <- SK-1
        twin = 1 if first else (k - 2 if last else failed - 1)
        side = "next" if twin > failed else "prev"
        return part.set_stage(params, failed, _align_layers(
            part.get_stage(params, twin), part.layer_counts[failed], side))

    if strategy == "copy_prev":
        src = failed - 1 if failed > 0 else failed + 1
        side = "prev" if src < failed else "next"
        return part.set_stage(params, failed, _align_layers(
            part.get_stage(params, src), part.layer_counts[failed], side))

    # weighted / uniform average of the two neighbours (intermediate stages)
    assert 0 < failed < k - 1, "edge stages need CheckFree+ (twin_copy)"
    n = part.layer_counts[failed]
    prev_s = _align_layers(part.get_stage(params, failed - 1), n, "prev")
    next_s = _align_layers(part.get_stage(params, failed + 1), n, "next")
    if strategy == "uniform":
        wa = torch.ones((), device=omegas.device)
        wb = torch.ones((), device=omegas.device)
    else:  # grad_norm (Alg. 1)
        wa = omegas[failed - 1].float()
        wb = omegas[failed + 1].float()
    _merge_trees(prev_s, next_s, wa, wb, out=part.get_stage(params, failed))
    return params


@torch.no_grad()
def recover_consecutive(params: Params, part: StagePartition,
                        failed_run: List[int], omegas: torch.Tensor,
                        ) -> Params:
    """BEYOND-PAPER: recover a run of CONSECUTIVE failed stages [i..j], in place.

    Stage k of the run is initialized from the survivors p = i-1 and
    q = j+1 with weights combining Alg. 1's gradient norms and the linear
    distance across the gap:

        a_k = omega_p * (q - k),  b_k = omega_q * (k - p)
        W_k = (a_k W_p + b_k W_q) / (a_k + b_k)

    For a run of length 1 this is Alg. 1.  Edge-touching runs (i == 0 or
    j == K-1) copy the single survivor into every lost stage.
    """
    run = sorted(failed_run)
    assert run == list(range(run[0], run[-1] + 1)), run
    i, j = run[0], run[-1]
    k_stages = part.num_stages
    p, q = i - 1, j + 1
    if p < 0 or q >= k_stages:
        src = q if p < 0 else p
        assert 0 <= src < k_stages, "entire pipeline lost"
        stage = part.get_stage(params, src)
        side = "next" if p < 0 else "prev"
        for k in run:
            part.set_stage(params, k,
                           _align_layers(stage, part.layer_counts[k], side))
        return params
    prev_s = part.get_stage(params, p)
    next_s = part.get_stage(params, q)
    for k in run:
        n = part.layer_counts[k]
        a = omegas[p].float() * (q - k)
        b = omegas[q].float() * (k - p)
        _merge_trees(_align_layers(prev_s, n, "prev"),
                     _align_layers(next_s, n, "next"), a, b,
                     out=part.get_stage(params, k))
    return params


def stage_sq_dist(a: Params, b: Params) -> torch.Tensor:
    """sum over leaves of ||a - b||^2 in fp32, for two stage trees."""
    sq = [(x.float() - y.float()).square_().sum()
          for x, y in zip(TR.leaves(a), TR.leaves(b))]
    return torch.stack(sq).sum()


def recovery_error(params_before: Params, params_after: Params,
                   part: StagePartition, failed: int) -> torch.Tensor:
    """||omega1 f_{k+1} + omega2 f_{k-1} - f_k||^2 — the per-failure error term
    from the paper's convergence bound (§4.4), measured directly.

    The recovery functions write in place, so ``params_before`` must be a
    copy taken before them (the strategies copy only the failed stages and
    call :func:`stage_sq_dist`).
    """
    return stage_sq_dist(part.get_stage(params_before, failed),
                         part.get_stage(params_after, failed))
