"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper runs these, and the kernel tests on the
card hold each CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


def _mask(sq: int, sk: int, causal: bool, window: int,
          device, q0: int = 0, k0: int = 0) -> torch.Tensor:
    """(Sq, Sk), True = attend: the JAX masks' meaning (``causal_mask(s,
    t)`` is ``kpos <= qpos``, ``swa_mask`` adds ``kpos > qpos - window``);
    cross-attention (Sq != Sk) is ``causal=False, window=0``, all true.
    ``q0``, ``k0``: the positions of the first query and key (a block of
    the whole mask)."""
    qpos = torch.arange(q0, q0 + sq, device=device)[:, None]
    kpos = torch.arange(k0, k0 + sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (out in q's dtype, lse fp32).

    The function of ``repro.kernels.ref.flash_attention_ref``, plus the
    per-row logsumexp ``lse`` (B, Hq, Sq) that the forward kernel writes.
    Sk may differ from Sq (cross-attention) with ``causal=False, window=0``.
    GQA: query head h reads kv head h // (Hq // Hkv).  Differentiable by
    PyTorch's own autograd.
    """
    d = q.shape[3]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) / math.sqrt(d)
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype), lse


def flash_attention_rows_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, block: int = 256,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref` computed over blocks of ``block`` query
    rows: (out in q's dtype, lse fp32), the same function.

    Each block takes the keys its rows can see under :func:`_mask` (up to
    its last row when causal, from its first row's window start), and each
    row's softmax runs in fp32 over all of that row's visible keys, so at
    most (B, Hq, block, Sk) fp32 scores live at once where the whole
    version builds (B, Hq, Sq, Sk): 137 GB a layer of qwen3-4b at 32,768
    tokens.  GQA by grouping the query heads over each kv head (no
    repeated k or v).  Every row must see at least one key, as under every
    mask the kernels take.  No autograd use: a plain version to compare
    with at long lengths.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    if block < 1:
        raise ValueError(f"flash_attention_rows_ref: block {block}")
    qg = q.reshape(b, hkv, g, sq, d)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    og = out.view(b, hkv, g, sq, d)
    lg = lse.view(b, hkv, g, sq)
    for r0 in range(0, sq, block):
        r1 = min(r0 + block, sq)
        lo = max(r0 - window + 1, 0) if window > 0 else 0
        hi = min(r1, sk) if causal else sk
        kk, vv = k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        logits = torch.einsum("bkgsd,bktd->bkgst", qg[:, :, :, r0:r1].float(),
                              kk).div_(math.sqrt(d))
        # the mask can hide only keys before the last row's window or after
        # the first row; every other key of the block is visible to all rows
        spans = []
        if window > 0:
            spans.append((lo, min(hi, r1 - window)))
        if causal:
            spans.append((max(lo, r0 + 1), hi))
        for a, z in spans:
            if a < z:
                mask = _mask(r1 - r0, z - a, causal, window, q.device, r0, a)
                logits[..., a - lo:z - lo].masked_fill_(~mask, NEG_INF)
        lg[..., r0:r1] = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        del logits
        og[..., r0:r1, :] = torch.einsum("bkgst,bktd->bkgsd", probs,
                                         vv).to(q.dtype)
    return out, lse


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
    with dK and dV summed over each kv head's group of query heads.  k/v may
    be Sk long (cross-attention, ``causal=False, window=0``).
    """
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    qf, dof = q.float(), do.float()
    logits = torch.einsum("bhsd,bhtd->bhst", qf * scale, kk)
    mask = _mask(s, sk, causal, window, q.device)
    p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    delta = (dof * out.float()).sum(-1)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vv)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kk) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    dk = dk.reshape(b, hkv, g, sk, d).sum(2)
    dv = dv.reshape(b, hkv, g, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_groups_ref(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor,
                                   causal: bool = True, window: int = 0,
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """:func:`flash_attention_bwd_ref` one kv head's group of query heads
    at a time: the same function (heads are independent), with at most
    (B, Hq / Hkv, Sq, Sk) fp32 scores live where the whole version builds
    (B, Hq, Sq, Sk): 2.2 GB a tensor at 32 heads over 4,160 tokens."""
    g = q.shape[1] // k.shape[1]
    parts = [flash_attention_bwd_ref(
        q[:, h * g:(h + 1) * g], k[:, h:h + 1], v[:, h:h + 1],
        out[:, h * g:(h + 1) * g], lse[:, h * g:(h + 1) * g],
        do[:, h * g:(h + 1) * g], causal, window)
        for h in range(k.shape[1])]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))


def stage_merge_ref(x: torch.Tensor, y: torch.Tensor, ca, cb) -> torch.Tensor:
    """``ca * x + cb * y`` in fp32, cast to x's dtype
    (``repro.kernels.ref.stage_merge_ref``)."""
    ca = torch.as_tensor(ca, dtype=torch.float32, device=x.device)
    cb = torch.as_tensor(cb, dtype=torch.float32, device=x.device)
    return (ca * x.float() + cb * y.float()).to(x.dtype)


def adam_sumsq_ref(grads: Sequence[torch.Tensor], tower: Sequence[bool],
                   layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-layer sums of squares (layers,), total), fp32: the tower leaves'
    rows along axis 0 summed per layer over the leaves, and every leaf's
    squares summed (the squares of ``repro.optim.adam.global_norm`` and of
    ``repro.core.stages.StagePartition.stage_grad_sqnorms``)."""
    per_layer = torch.zeros(layers, dtype=torch.float32,
                            device=grads[0].device)
    for g, t in zip(grads, tower):
        if t:
            per_layer = per_layer + g.float().square().reshape(layers, -1).sum(1)
    total = torch.stack([g.float().square().sum() for g in grads]).sum()
    return per_layer, total


@torch.no_grad()
def adam_update_ref(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
                    v: Sequence[torch.Tensor], scalars: torch.Tensor, *,
                    betas: Tuple[float, float], eps: float,
                    weight_decay: float, clip: bool) -> None:
    """One Adam step of every leaf, in place (``repro/optim/adam.py:79-104``):
    ``scalars`` = (clip scale, lr, bc1, bc2), fp32 on the leaves' device."""
    scale, lr, bc1, bc2 = scalars.unbind()
    b1, b2 = betas
    for p, g, mm, vv in zip(params, grads, m, v):
        g = g.float()
        if clip:
            g = g * scale
        mm.mul_(b1).add_(g, alpha=1 - b1)
        vv.mul_(b2).add_(g.square(), alpha=1 - b2)
        delta = (mm / bc1).mul_(lr).div_((vv / bc2).sqrt_().add_(eps))
        if weight_decay > 0:
            delta.add_(p.float() * (lr * weight_decay))
        p.sub_(delta.to(p.dtype))


def ssd_scan_ref(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, init_state: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence token by token (its definition), kernel layout.

    x: (B, H, T, P); a: (B, H, T) log decay; bmat/cmat: (B, G, T, N), head h
    reading group h // (H / G); init_state: optional (B, H, P, N).  Returns
    (y (B, H, T, P) in x's dtype, final state (B, H, P, N) fp32): the function
    of ``repro.kernels.ref.ssd_scan_ref``, plus the state it starts from and
    the state it ends in.
    """
    b, h, t, p = x.shape
    r = h // bmat.shape[1]
    bh = bmat.float().repeat_interleave(r, dim=1)
    ch = cmat.float().repeat_interleave(r, dim=1)
    state = (torch.zeros((b, h, p, bmat.shape[3]), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    da = torch.exp(a.float())
    xf = x.float()
    ys = []
    for i in range(t):
        state = (state * da[:, :, i, None, None]
                 + xf[:, :, i, :, None] * bh[:, :, i, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, :, i]))
    return torch.stack(ys, dim=2).to(x.dtype), state


def ssd_chunked(xb: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan of ``repro.models.ssm.ssd_chunked``, model layout.

    xb: (B, T, H, P) dt-weighted inputs; a: (B, T, H) log decay (dt * A);
    bmat/cmat: (B, T, G, N); init_state: optional (B, H, P, N).  Returns
    (y (B, T, H, P) in xb's dtype, final state (B, H, P, N) fp32).  Where the
    JAX code asserts T % chunk == 0, a ragged last chunk is padded here with
    tokens that carry nothing (x = B = C = 0, a = 0), as the kernel masks
    it; the padded rows of y are dropped.  The decay is exponentiated only
    where j <= i: the masked entries' exponents can overflow to inf, which
    ``torch.where`` would discard in the forward but not in a gradient.
    Sums run in fp32, or in float64 for float64 inputs (the gradient tests'
    oracle).
    """
    b, t, h, p = xb.shape
    g, n = bmat.shape[2], bmat.shape[3]
    r = h // g
    xc, ac, bc, cc = _chunked(xb, a, bmat, cmat, chunk)
    nc, wd = xc.shape[1], xc.dtype

    cs = torch.cumsum(ac, dim=2)                                 # (b,nc,q,h)
    # intra-chunk quadratic term
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)
    cbh = cb.repeat_interleave(r, dim=2)                         # (b,nc,h,q,k)
    csh = cs.movedim(3, 2)                                       # (b,nc,h,q)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xb.device))
    expo = csh[..., :, None] - csh[..., None, :]
    decay = torch.exp(torch.where(mask, expo, 0.0))
    att = torch.where(mask, cbh * decay, 0.0)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", att, xc)

    # per-chunk states
    w_end = torch.exp(cs[:, :, -1:, :] - cs)                     # (b,nc,q,h)
    bh = bc.repeat_interleave(r, dim=3)                          # (b,nc,q,h,n)
    s_chunk = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", bh, xc, w_end)
    d_tot = torch.exp(cs[:, :, -1, :])                           # (b,nc,h)

    # inter-chunk recurrence
    state = (torch.zeros((b, h, p, n), dtype=wd, device=xb.device)
             if init_state is None else init_state.to(wd))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * d_tot[:, c, :, None, None] + s_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (b,nc,h,p,n)

    # inter-chunk output
    ch = cc.repeat_interleave(r, dim=3)                          # (b,nc,q,h,n)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", ch, prev_states)
    y_inter = y_inter * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)[:, :t]
    return y.to(xb.dtype), state


def _chunked(xb, a, bmat, cmat, chunk: int, *more: torch.Tensor):
    """The inputs in the working type (fp32, or float64 for float64 inputs),
    a ragged end padded with tokens that carry nothing, cut into chunks:
    xb and ``more`` (each shaped like xb) (B, nc, Q, H, P), a (B, nc, Q, H),
    bmat/cmat (B, nc, Q, G, N)."""
    b, t, h, p = xb.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if chunk < 1:
        raise ValueError(f"ssd_chunked: chunk {chunk}")
    wd = torch.promote_types(xb.dtype, torch.float32)
    pad = -t % chunk
    nc = (t + pad) // chunk
    seq = [v.to(wd) for v in (xb, bmat, cmat, *more)]
    af = a.to(wd)
    if pad:
        seq = [torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) for v in seq]
        af = torch.nn.functional.pad(af, (0, 0, 0, pad))
    xf, bf, cf, *mf = seq
    return (xf.reshape(b, nc, chunk, h, p), af.reshape(b, nc, chunk, h),
            bf.reshape(b, nc, chunk, g, n), cf.reshape(b, nc, chunk, g, n),
            *(v.reshape(b, nc, chunk, h, p) for v in mf))


def ssd_chunked_bwd_ref(xb: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                        cmat: torch.Tensor, chunk: int,
                        init_state: Optional[torch.Tensor],
                        dy: Optional[torch.Tensor],
                        dfinal: Optional[torch.Tensor],
                        ) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`ssd_chunked`, written out chunk by chunk: the
    function of ``csrc/ssd_scan_bwd.cu``.

    dy (B, T, H, P) and dfinal (B, H, P, N) are the gradients of y and of
    the final state (None for zeros); init_state as in the forward.
    Returns (dxb like xb, da (B, T, H) in a's dtype, dbmat like bmat, dcmat
    like cmat, dinit (B, H, P, N) in the working type: the gradient of the
    starting state, whether given or zeros).

    Per chunk, with cs the chunk-local inclusive cumsum of a, L its last
    token, S the state the chunk starts from (a forward walk recomputes it)
    and dS the gradient of the state it ends in (a reverse walk from
    dfinal: dS_{c-1} = e^{cs_L} dS_c + sum_t e^{cs_t} dy_t C_t^T):

    * dx_j = sum_{i>=j} (C_i.B_j) e^{cs_i-cs_j} dy_i + e^{cs_L-cs_j} dS B_j
    * dB_j = sum_{i>=j} e^{cs_i-cs_j} (dy_i.x_j) C_i + e^{cs_L-cs_j} dS^T x_j
    * dC_i = sum_{j<=i} e^{cs_i-cs_j} (dy_i.x_j) B_j + e^{cs_i} S^T dy_i
    * d cs_i = sum_{j<i} M_ij - sum_{k>i} M_ki + e^{cs_i} C_i.(S^T dy_i)
      - u_i, with M_ij = (C_i.B_j) e^{cs_i-cs_j} (dy_i.x_j) and
      u_i = e^{cs_L-cs_i} x_i.(dS B_i); d cs_L also takes sum_i u_i +
      e^{cs_L} <dS, S>.  da is the in-chunk reverse cumsum of d cs.

    dB and dC sum over the heads of each group.  As in the forward, the
    decay is exponentiated only where j <= i, so the real decay range gives
    finite gradients.
    """
    b, t, h, p = xb.shape
    g, n = bmat.shape[2], bmat.shape[3]
    r = h // g
    if dy is None:
        dy = torch.zeros_like(xb)
    xc, ac, bc, cc, dyc = _chunked(xb, a, bmat, cmat, chunk, dy)
    nc, wd = xc.shape[1], xc.dtype
    cs = torch.cumsum(ac, dim=2)                                 # (b,nc,q,h)
    bh = bc.repeat_interleave(r, dim=3)                          # (b,nc,q,h,n)
    ch = cc.repeat_interleave(r, dim=3)
    csh = cs.movedim(3, 2)                                       # (b,nc,h,q)
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=xb.device))
    expo = csh[..., :, None] - csh[..., None, :]
    decay = torch.where(lower, torch.exp(torch.where(lower, expo, 0.0)), 0.0)
    cb = torch.einsum("bcqhn,bckhn->bchqk", ch, bh)              # C_i . B_j
    dyx = torch.einsum("bcqhp,bckhp->bchqk", dyc, xc)            # dy_i . x_j
    att = cb * decay
    e_mat = dyx * decay

    # the forward walk: the state each chunk starts from
    w_end = torch.exp(cs[:, :, -1:, :] - cs)                     # (b,nc,q,h)
    s_chunk = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", bh, xc, w_end)
    d_tot = torch.exp(cs[:, :, -1, :])                           # (b,nc,h)
    state = (torch.zeros((b, h, p, n), dtype=wd, device=xb.device)
             if init_state is None else init_state.to(wd))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * d_tot[:, c, :, None, None] + s_chunk[:, c]
    prev = torch.stack(prev, dim=1)                              # (b,nc,h,p,n)

    # the reverse walk: the gradient of the state each chunk ends in
    ecs = torch.exp(cs)                                          # (b,nc,q,h)
    d_state = (torch.zeros((b, h, p, n), dtype=wd, device=xb.device)
               if dfinal is None else dfinal.to(wd))
    after = [None] * nc
    for c in reversed(range(nc)):
        after[c] = d_state
        d_state = d_state * d_tot[:, c, :, None, None] + torch.einsum(
            "bqhp,bqhn,bqh->bhpn", dyc[:, c], ch[:, c], ecs[:, c])
    after = torch.stack(after, dim=1)                            # (b,nc,h,p,n)

    # each chunk's own work
    r_mat = torch.einsum("bckhn,bchpn->bckhp", bh, after)        # dS B_j
    dx = torch.einsum("bchqk,bcqhp->bckhp", att, dyc) + w_end[..., None] * r_mat
    db = (torch.einsum("bchqk,bcqhn->bckhn", e_mat, ch)
          + w_end[..., None] * torch.einsum("bckhp,bchpn->bckhn", xc, after))
    v = torch.einsum("bcqhp,bchpn->bcqhn", dyc, prev)            # S^T dy_i
    dc = torch.einsum("bchqk,bckhn->bcqhn", e_mat, bh) + ecs[..., None] * v
    strict = torch.tril(lower, diagonal=-1)
    m = torch.where(strict, cb * e_mat, 0.0)
    dcs = (m.sum(-1) - m.sum(-2)).movedim(2, 3)                  # (b,nc,q,h)
    u = w_end * (xc * r_mat).sum(-1)
    dcs = dcs + ecs * (ch * v).sum(-1) - u
    last = u.sum(2) + d_tot * (after * prev).sum((-2, -1))       # (b,nc,h)
    dcs = torch.cat([dcs[:, :, :-1], dcs[:, :, -1:] + last[:, :, None]], 2)
    da = dcs.flip(2).cumsum(2).flip(2)

    def unchunk(v):
        return v.reshape(b, nc * chunk, *v.shape[3:])[:, :t]

    db = db.reshape(b, nc, chunk, g, r, n).sum(4)
    dc = dc.reshape(b, nc, chunk, g, r, n).sum(4)
    return (unchunk(dx).to(xb.dtype), unchunk(da).to(a.dtype),
            unchunk(db).to(bmat.dtype), unchunk(dc).to(cmat.dtype), d_state)
