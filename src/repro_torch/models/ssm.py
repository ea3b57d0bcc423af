"""Mamba2 / SSD (state-space duality) family, in PyTorch (mamba2-1.3b).

The counterpart of ``repro.models.ssm``, function for function.  The full
sequence runs the chunked SSD scan through ``kernels.ops.ssd_scan``: on the
card the hand-written kernels (``csrc/ssd_scan.cu``, and
``csrc/ssd_scan_bwd.cu`` for its gradient in training), on the CPU the
plain ``ssd_chunked`` and PyTorch's autograd of it, where the JAX code
calls its own ``ssd_chunked``.  Decode
runs the exact one-token recurrence against a (state, conv tail) cache in
plain PyTorch, as the JAX package computes it outside any kernel.  Where JAX
scans the stacked blocks, a Python loop walks views of them
(``transformer.unstack``).

Parameters arrive already in ``cfg.dtype`` (``models.model.Model`` casts
them once, as the JAX code's ``cast_tree`` does on every call), so
``a_log``, ``dt_bias`` and ``d_skip`` enter a bf16 model as bf16 values.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401  (the JAX name)
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_order, unstack

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# depthwise causal conv1d
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: (B, L, C); w: (K, C) depthwise taps; b: (C,)."""
    k, ln = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = sum(xp[:, i:i + ln, :] * w[i] for i in range(k))
    return y + b


def conv1d_decode(x_new: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_new: (B, C); state: (B, K-1, C) last K-1 inputs (oldest first)."""
    k = w.shape[0]
    y = x_new * w[k - 1]
    for i in range(k - 1):
        y = y + state[:, i, :] * w[i]
    new_state = torch.cat([state[:, 1:, :], x_new[:, None, :]], dim=1)
    return y + b, new_state


# ---------------------------------------------------------------------------
# SSD: the one-token recurrence (the full sequence is kernels.ops.ssd_scan)
# ---------------------------------------------------------------------------

def ssd_recurrent_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact single-token recurrence (decode).

    state: (B, H, P, N); x: (B, H, P); dt: (B, H); bmat/cmat: (B, G, N).
    Returns (y (B, H, P) in x's dtype, new fp32 state).
    """
    r = state.shape[1] // bmat.shape[1]
    amt = -torch.exp(a_log.float())                          # (H,)
    da = torch.exp(dt.float() * amt)                         # (B, H)
    bh = bmat.repeat_interleave(r, dim=1).float()            # (B, H, N)
    ch = cmat.repeat_interleave(r, dim=1).float()
    xdt = x.float() * dt.float()[..., None]
    new_state = state * da[..., None, None] + xdt[..., :, None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# mamba2 block
# ---------------------------------------------------------------------------

def block_dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, conv channels, in-projection width, state dim)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.ngroups * s.state_dim
    proj_out = 2 * d_in + 2 * s.ngroups * s.state_dim + nheads
    return d_in, nheads, conv_ch, proj_out, s.state_dim


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                     layers: int) -> Params:
    """Mamba2 blocks of ``layers`` layers, stacked on axis 0."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, nheads, conv_ch, proj_out, _ = block_dims(cfg)
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] log-uniformly
    # (the mamba default): the inverse softplus of the draw
    u = torch.rand((layers, nheads), generator=gen, device=device)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    a_log = torch.log(torch.linspace(1.0, 16.0, nheads, device=device))
    conv_w = 0.1 * torch.randn((layers, s.conv_width, conv_ch), generator=gen,
                               device=device)
    return {
        "norm": L.init_rmsnorm((layers, d), dtype, device),
        "w_in": L.dense_init(gen, (layers, d, proj_out), dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((layers, conv_ch), dtype=dtype, device=device),
        "a_log": a_log.expand(layers, nheads).clone(),
        "dt_bias": dt_bias,
        "d_skip": torch.ones((layers, nheads), dtype=torch.float32,
                             device=device),
        "gate_norm": L.init_rmsnorm((layers, d_in), dtype, device),
        "w_out": L.dense_init(gen, (layers, d_in, d), dtype, device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, _, _, _, n = block_dims(cfg)
    gn = cfg.ssm.ngroups * n
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * gn]
    dt = zxbcdt[..., d_in + d_in + 2 * gn:]
    return z, xbc, dt


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    d_in, _, _, _, n = block_dims(cfg)
    gn = cfg.ssm.ngroups * n
    return xbc[..., :d_in], xbc[..., d_in:d_in + gn], xbc[..., d_in + gn:]


def _chunk(cfg: ModelConfig, t: int) -> int:
    """The JAX choice: the largest divisor of T that is <= chunk_size."""
    chunk = min(cfg.ssm.chunk_size, t)
    while t % chunk:
        chunk -= 1
    return chunk


def mamba_block(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                init_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full-sequence mamba2 block: x (B, T, d) -> (B, T, d).

    ``return_state``: also return (final SSM state (B, H, P, N) fp32, conv
    tail (B, K-1, conv channels)), the decode cache of this layer.  B and C
    reach the scan as strided views of the conv output, without a copy.
    """
    s = cfg.ssm
    b, t, _ = x.shape
    d_in, nheads, _, _, n = block_dims(cfg)
    h = L.rmsnorm(bp["norm"], x, cfg.rmsnorm_eps)
    zxbcdt = h @ bp["w_in"]
    z, xbc_raw, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = F.silu(causal_conv1d(xbc_raw, bp["conv_w"], bp["conv_b"]))
    xs, bmat, cmat = _split_xbc(cfg, xbc)
    xs = xs.reshape(b, t, nheads, s.head_dim)
    bmat = bmat.reshape(b, t, s.ngroups, n)
    cmat = cmat.reshape(b, t, s.ngroups, n)
    # fp32 + the parameter's dtype promotes to fp32, as in the JAX code
    dt = F.softplus(dt_raw.float() + bp["dt_bias"])           # (b, t, H)
    amt = -torch.exp(bp["a_log"])                             # (H,)
    a = dt * amt
    xb = xs * dt[..., None].to(xs.dtype)
    y, final_state = ops.ssd_scan(xb, a, bmat, cmat, chunk=_chunk(cfg, t),
                                  init_state=init_state)
    y = y + xs * bp["d_skip"][:, None].to(xs.dtype)
    y = y.reshape(b, t, d_in)
    y = L.rmsnorm(bp["gate_norm"], y * F.silu(z), cfg.rmsnorm_eps)
    out = y @ bp["w_out"]
    if return_state:
        # conv tail: the last K-1 pre-activation conv inputs, zeros in front
        # of a prompt shorter than that
        k = s.conv_width
        tail = xbc_raw[:, max(t - (k - 1), 0):, :]
        tail = F.pad(tail, (0, 0, (k - 1) - tail.shape[1], 0))
        return out, (final_state, tail)
    return out


def mamba_block_decode(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                       ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One-token decode: x (B, 1, d) -> (out (B, 1, d), new ssm, new conv)."""
    s = cfg.ssm
    b = x.shape[0]
    d_in, nheads, _, _, n = block_dims(cfg)
    h = L.rmsnorm(bp["norm"], x[:, 0, :], cfg.rmsnorm_eps)
    zxbcdt = h @ bp["w_in"]
    z, xbc_raw, dt_raw = _split_proj(cfg, zxbcdt)
    xbc, new_conv = conv1d_decode(xbc_raw, conv_state, bp["conv_w"],
                                  bp["conv_b"])
    xbc = F.silu(xbc)
    xs, bmat, cmat = _split_xbc(cfg, xbc)
    xs = xs.reshape(b, nheads, s.head_dim)
    bmat = bmat.reshape(b, s.ngroups, n)
    cmat = cmat.reshape(b, s.ngroups, n)
    dt = F.softplus(dt_raw.float() + bp["dt_bias"])           # (b, H)
    y, new_state = ssd_recurrent_step(ssm_state, xs, dt, bp["a_log"], bmat,
                                      cmat)
    y = y + xs * bp["d_skip"][:, None].to(xs.dtype)
    y = y.reshape(b, d_in)
    y = L.rmsnorm(bp["gate_norm"], y * F.silu(z), cfg.rmsnorm_eps)
    return (y @ bp["w_out"])[:, None, :], new_state, new_conv


# ---------------------------------------------------------------------------
# full model (mamba2-1.3b style: pure SSM tower)
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(params["embed"], tokens).to(L.to_dtype(cfg.dtype))


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.unembed_w(params["head"], x)


def init(gen: torch.Generator, cfg: ModelConfig, device,
         dtype=None) -> Params:
    """Fresh parameters drawn from ``gen`` on ``device``, in
    ``cfg.param_dtype`` or each leaf cast to ``dtype`` as it is drawn
    (``transformer.init``)."""
    dtype = L.to_dtype(dtype or cfg.param_dtype)
    params: Params = {
        "embed": {"table": L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                        dtype, device)},
        "blocks": init_mamba_block(gen, cfg, dtype, device, cfg.num_layers),
        "final_norm": L.init_rmsnorm((cfg.d_model,), dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                            dtype, device)}
    return params


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            order: Optional[Sequence[int]] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, T) -> (logits (B, T, V), aux): the JAX family's
    ``return_aux`` form, aux a 0-d fp32 0 (no MoE layer).

    ``order`` walks the ``"blocks"`` tower in that order (CheckFree+'s
    swapped stages), the counterpart of the JAX trainer's ``_permute_tower``
    before ``ssm.forward``; with autograd on this is the training forward.
    """
    x = embed_tokens(params, cfg, tokens)
    blocks = unstack(params["blocks"], cfg.num_layers)
    for i in layer_order(cfg.num_layers, order):
        x = x + mamba_block(blocks[i], x, cfg)
    logits = logits_from_hidden(params, cfg, x)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device,
               dtype=None) -> Params:
    """The SSM state is O(1) in the sequence length: ``capacity`` is unused."""
    del capacity
    s = cfg.ssm
    _, nheads, conv_ch, _, n = block_dims(cfg)
    lcount = cfg.num_layers
    return {
        "ssm": torch.zeros((lcount, batch, nheads, s.head_dim, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((lcount, batch, s.conv_width - 1, conv_ch),
                            dtype=L.to_dtype(dtype or cfg.dtype), device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill_layers(blocks: Sequence[Params], x: torch.Tensor,
                   cfg: ModelConfig, cache: Params,
                   layers: Iterable[int]) -> torch.Tensor:
    """Run mamba2 layers ``layers`` over the prompt; each writes its final
    state and conv tail into its slot of the cache."""
    for i in layers:
        out, (state, tail) = mamba_block(blocks[i], x, cfg, return_state=True)
        x = x + out
        cache["ssm"][i].copy_(state)
        cache["conv"][i].copy_(tail)
    return x


def decode_layers(blocks: Sequence[Params], x: torch.Tensor, cfg: ModelConfig,
                  cache: Params, layers: Iterable[int]) -> torch.Tensor:
    """Run mamba2 layers ``layers`` on one token, updating their cache slots
    in place."""
    for i in layers:
        out, nst, ncv = mamba_block_decode(blocks[i], x, cfg, cache["ssm"][i],
                                           cache["conv"][i])
        x = x + out
        cache["ssm"][i].copy_(nst)
        cache["conv"][i].copy_(ncv)
    return x


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            capacity: int = 0) -> Tuple[torch.Tensor, Params]:
    """Forward over the prompt -> (last-token logits (B, 1, V), cache)."""
    b, t = tokens.shape
    cache = init_cache(cfg, b, capacity, tokens.device)
    x = prefill_layers(unstack(params["blocks"], cfg.num_layers),
                       embed_tokens(params, cfg, tokens), cfg, cache,
                       range(cfg.num_layers))
    cache["pos"].fill_(t)
    return logits_from_hidden(params, cfg, x[:, -1:, :]), cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, **_) -> Tuple[torch.Tensor, Params]:
    """tokens: (B,) -> (logits (B, 1, V), cache).  The cache's states are
    updated in place (the returned cache shares them); ``pos`` advances."""
    x = decode_layers(unstack(params["blocks"], cfg.num_layers),
                      embed_tokens(params, cfg, tokens[:, None]), cfg, cache,
                      range(cfg.num_layers))
    logits = logits_from_hidden(params, cfg, x)
    return logits, {"ssm": cache["ssm"], "conv": cache["conv"],
                    "pos": cache["pos"] + 1}
