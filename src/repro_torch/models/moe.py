"""Mixture-of-Experts MLP layer (token-choice top-k router), in PyTorch.

The counterpart of ``repro.models.moe``: GShard/Switch-style capacity-based
dispatch.  Tokens are grouped (``_group_size``), each group's router picks
``top_k`` experts a token, and each expert takes at most ``capacity`` tokens
of a group, handed out choice by choice: every token's first choice is
placed before any second choice, and a choice past the capacity is dropped.

Two forms compute the same function:

* :func:`topk_dispatch` and :func:`moe_mlp_onehot` — the JAX code line for
  line: one-hot dispatch and combine tensors (G, T, E, C) and einsums that
  move tokens by multiplying with them.  The port's plain version, used by
  the tests and the card's checks, never by the model.
* :func:`moe_mlp` — the main path.  The same routing (``topi``, the slots,
  the drops) moves tokens by index: a slot -> (token, choice) map gathers the
  experts' inputs, and each token gathers its k outputs back.  At
  granite-moe-3b-a800m's serving shape the one-hot tensors hold 21 M
  elements a layer and the einsums multiply by 0 or 1 for 40% of the layer's
  FLOPs; the gathers move d values a slot.  Still static-shaped (no host
  read, no shape that depends on the data), so a CUDA graph captures it.

Gathers' default backward (``index_add_``) sums by atomics on the card, in
no fixed order.  The dispatch and the combine are ``autograd.Function``s
whose backwards are gathers too, summed over the k choices in the order
j = 0 .. k-1 in fp32 and rounded once, so that two runs give the same bits.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]

CAPACITY_FACTOR = 1.25


def init_moe_layer(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                   layers: Optional[int]) -> Params:
    """The MoE layer's weights, stacked on axis 0 as ``init_block``'s other
    leaves: the router (d, E) in fp32, the experts' gated MLPs (E, d, f) and
    (E, f, d) at std 1/sqrt(fan_in), and the shared experts' gated MLP of
    width ``num_shared_experts * d_ff_expert``."""
    m = cfg.moe
    d, ffe, e = cfg.d_model, m.d_ff_expert, m.num_experts
    n = () if layers is None else (layers,)
    p: Params = {
        "router": L.dense_init(gen, (*n, d, e), torch.float32, device),
        "w_gate": L.dense_init(gen, (*n, e, d, ffe), dtype, device),
        "w_up": L.dense_init(gen, (*n, e, d, ffe), dtype, device),
        "w_down": L.dense_init(gen, (*n, e, ffe, d), dtype, device),
    }
    if m.num_shared_experts > 0:
        p["shared"] = L.init_mlp(gen, d, m.num_shared_experts * ffe, dtype,
                                 device, layers)
    return p


def _group_size(total_tokens: int, seq: int) -> int:
    """The largest of 4096 .. 1 that is at most ``min(seq, cap)`` and divides
    ``seq``; ``cap`` is ``REPRO_MOE_GROUP`` (default 4096), read as the JAX
    package reads it, so that both group alike."""
    del total_tokens
    cap = int(os.environ.get("REPRO_MOE_GROUP", "4096"))
    for cand in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if cand <= min(seq, cap) and seq % cand == 0:
            return cand
    return 1


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Slots per expert and group."""
    m = cfg.moe
    return max(1, int(math.ceil(tokens_per_group * m.top_k / m.num_experts
                                * m.capacity_factor)))


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest gates, the lower index first among
    equal values, as ``jax.lax.top_k`` (``torch.topk`` promises no order for
    ties): a stable descending sort, cut at k."""
    with torch.no_grad():
        idx = torch.sort(gates, dim=-1, descending=True, stable=True
                         ).indices[..., :k]
    return torch.gather(gates, -1, idx), idx


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot rows of ``idx`` over n classes; an index outside [0, n) gives
    a zero row, as ``jax.nn.one_hot`` (``F.one_hot`` would raise)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def aux_loss(gates: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum(mean gate * top-1 share)."""
    e = gates.shape[-1]
    me = gates.mean(dim=(0, 1))
    ce = _one_hot(topi[..., 0], e, torch.float32).mean(dim=(0, 1))
    return e * torch.sum(me * ce)


def topk_dispatch(gates: torch.Tensor, k: int, capacity: int, dtype,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates: (G, T, E) fp32 router probabilities -> (dispatch (G, T, E, C),
    combine (G, T, E, C), both in ``dtype``, aux loss): the one-hot form."""
    g, t, e = gates.shape
    topv, topi = top_k(gates, k)
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    dispatch = torch.zeros((g, t, e, capacity), dtype=dtype,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    offsets = torch.zeros((g, e), dtype=torch.int64, device=gates.device)
    for j in range(k):
        m = _one_hot(topi[..., j], e, torch.int64)                # (G, T, E)
        pos = torch.cumsum(m, dim=1) - m + offsets[:, None, :]   # exclusive
        keep = (pos < capacity) & (m > 0)
        pos_oh = _one_hot(torch.where(keep, pos, capacity), capacity, dtype)
        dj = pos_oh * keep[..., None].to(dtype)
        dispatch = dispatch + dj
        combine = combine + dj * topv[..., j, None, None].to(dtype)
        offsets = offsets + m.sum(dim=1)
    return dispatch, combine, aux_loss(gates, topi)


def moe_mlp_onehot(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`moe_mlp`: ``repro.models.moe.moe_mlp``'s
    one-hot einsums.  x: (B, S, d) -> (out (B, S, d), aux)."""
    m = cfg.moe
    b, s, d = x.shape
    tg = _group_size(b * s, s)
    xg = x.reshape(b * s // tg, tg, d)
    gates = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
    dispatch, combine, aux = topk_dispatch(gates, m.top_k, capacity(tg, cfg),
                                           x.dtype)
    ein = torch.einsum("gtd,gtec->gecd", xg, dispatch)
    h = L._act(cfg.act, torch.einsum("gecd,edf->gecf", ein, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", ein, p["w_up"])
    eout = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    out = torch.einsum("gecd,gtec->gtd", eout, combine).reshape(b, s, d)
    if m.num_shared_experts > 0:
        out = out + L.mlp(p["shared"], x, cfg.act)
    return out, aux


# ---------------------------------------------------------------------------
# the index form (the main path)
# ---------------------------------------------------------------------------

class Routing(NamedTuple):
    """One layer's routing of G groups of T tokens.

    ``gates`` (G, T, E) fp32; ``topv`` (G, T, k) the normalized weights of
    the chosen experts ``topi``; ``pos`` (G, T, k) each choice's slot in its
    expert; ``keep`` (G, T, k) whether that slot is within the capacity."""
    gates: torch.Tensor
    topv: torch.Tensor
    topi: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def slots(topi: torch.Tensor, num_experts: int, cap: int,
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, keep), each (G, T, k): choice j of token t takes slot
    ``pos = #{t' < t choosing e at j} + offsets[e]`` of its expert e, where
    ``offsets`` counts the choices 0 .. j-1 of the whole group for e — the
    integers of ``topk_dispatch``'s one-hot cumsum; kept where pos < cap.

    One running count over the choices laid out choice-major ((j, t): every
    first choice before any second), each expert's count along the last
    axis of an (G, E, k*T) one-hot; a choice's slot is the count of its
    expert just before it."""
    g, t, k = topi.shape
    seq = topi.transpose(1, 2).reshape(g, 1, k * t)              # (j, t)
    experts = torch.arange(num_experts, device=topi.device)[None, :, None]
    counts = torch.cumsum((seq == experts).to(torch.int32), dim=-1,
                          dtype=torch.int32)                      # (G, E, kT)
    pos = torch.gather(counts, 1, seq).to(torch.int64) - 1        # (G, 1, kT)
    pos = pos.reshape(g, k, t).transpose(1, 2)
    return pos, pos < cap


def route(p: Params, xg: torch.Tensor, cfg: ModelConfig,
          cap: int) -> Routing:
    """The router of ``moe_mlp`` on (G, T, d) groups: fp32 logits and
    softmax, the top-k, their slots.  The router weight arrives in the
    compute dtype (the model casts every leaf, as JAX's ``cast_tree``)."""
    m = cfg.moe
    gates = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
    topv, topi = top_k(gates, m.top_k)
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    with torch.no_grad():
        pos, keep = slots(topi, m.num_experts, cap)
    return Routing(gates, topv, topi, pos, keep)


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` (N, ...) with a zero row N appended, which sentinel indices
    read."""
    return torch.cat([x, x.new_zeros((1, *x.shape[1:]))])


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``x`` (N, ...), where index N reads a zero row."""
    return _padded(x).index_select(0, idx)


def _sum_choices(rows: torch.Tensor, dst: torch.Tensor,
                 w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[n] = sum over j = 0 .. k-1, in that order, of rows[dst[n, j]]
    (times ``w[n, j]``), in fp32, rounded once to ``rows``' dtype; the
    sentinel ``rows.shape[0]`` adds nothing."""
    pad = _padded(rows)
    acc = None
    for j in range(dst.shape[1]):
        r = pad.index_select(0, dst[:, j]).float()
        if w is not None:
            r = r * w[:, j, None].float()
        acc = r if acc is None else acc + r
    return acc.to(rows.dtype)


class _Dispatch(torch.autograd.Function):
    """ein[s] = x[src[s] // k] (a zero row for an empty slot).  Backward:
    dx[n] = sum_j dein[dst[n, j]] — a gather, not an atomic scatter."""

    @staticmethod
    def forward(ctx, x, src, dst):
        ctx.save_for_backward(dst)
        return _rows(x, torch.div(src, dst.shape[1], rounding_mode="floor"))

    @staticmethod
    def backward(ctx, dein):
        dst, = ctx.saved_tensors
        return _sum_choices(dein, dst), None, None


class _Combine(torch.autograd.Function):
    """out[n] = sum_j w[n, j] * eout[dst[n, j]] (fp32 sum, one rounding).
    Backward: deout[s] = w of the slot's choice * dout of its token, and
    dw[n, j] = <dout[n], eout[dst[n, j]]>, both gathers."""

    @staticmethod
    def forward(ctx, eout, w, src, dst):
        ctx.save_for_backward(eout, w, src, dst)
        return _sum_choices(eout, dst, w)

    @staticmethod
    def backward(ctx, dout):
        eout, w, src, dst = ctx.saved_tensors
        k = dst.shape[1]
        deout = dw = None
        if ctx.needs_input_grad[0]:
            tok = torch.div(src, k, rounding_mode="floor")
            w_slot = _rows(w.reshape(-1, 1), src)
            deout = (_rows(dout, tok).float() * w_slot.float()).to(eout.dtype)
        if ctx.needs_input_grad[1]:
            d32, pad = dout.float(), _padded(eout)
            dw = torch.stack([(d32 * pad.index_select(0, dst[:, j]).float()
                               ).sum(-1) for j in range(k)],
                             dim=-1).to(w.dtype)
        return deout, dw, None, None


def slot_maps(r: Routing, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) of the index form, slots laid out expert-major (E, G, C):

    ``dst`` (G*T, k): the flat slot of each choice, or E*G*C where dropped;
    ``src`` (E*G*C,): the flat choice n*k + j that holds each slot, or
    G*T*k where the slot is empty.  Only kept choices reach a real slot,
    and no two share one, so the scatter writes each real slot once."""
    g, t, k = r.topi.shape
    e = r.gates.shape[-1]
    n_slots = e * g * cap
    group = torch.arange(g, device=r.topi.device)[:, None, None]
    dst = torch.where(r.keep, (r.topi * g + group) * cap + r.pos, n_slots)
    dst = dst.reshape(g * t, k)
    src = torch.full((n_slots + 1,), g * t * k, dtype=torch.int64,
                     device=dst.device)
    src.scatter_(0, dst.reshape(-1),
                 torch.arange(g * t * k, device=dst.device))
    return src[:n_slots], dst


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss): ``repro.models.moe.moe_mlp``
    by index.  The experts run as one batched product over E on their
    (G*C, d) slots."""
    m = cfg.moe
    b, s, d = x.shape
    tg = _group_size(b * s, s)
    g = b * s // tg
    cap = capacity(tg, cfg)
    xg = x.reshape(g, tg, d)
    r = route(p, xg, cfg, cap)
    with torch.no_grad():
        src, dst = slot_maps(r, cap)
    e = m.num_experts
    ein = _Dispatch.apply(x.reshape(g * tg, d), src, dst).view(e, g * cap, d)
    h = L._act(cfg.act, torch.bmm(ein, p["w_gate"])) * torch.bmm(ein,
                                                                 p["w_up"])
    eout = torch.bmm(h, p["w_down"]).view(e * g * cap, d)
    w = r.topv.to(x.dtype).reshape(g * tg, m.top_k)
    out = _Combine.apply(eout, w, src, dst).view(b, s, d)
    if m.num_shared_experts > 0:
        out = out + L.mlp(p["shared"], x, cfg.act)
    return out, aux_loss(r.gates, r.topi)
