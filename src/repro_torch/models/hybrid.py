"""Hybrid SSM + attention family (zamba2-style), in PyTorch.

The counterpart of ``repro.models.hybrid``: a Mamba2 backbone with one
*shared* attention + MLP block applied after every ``cfg.attn_every`` SSM
layers, the same parameters at every application.  The SSM layers run
``models.ssm.mamba_block`` (the SSD kernel on the card); each application
of the shared block runs ``layers.attention``, which on the card is the
flash-attention forward kernel (zamba2-2.7b: 32 heads of 80), and in
training its two backward kernels.  Serving keeps
one KV cache per application (segment) and one SSM state and conv tail per
SSM layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def _nseg(cfg: ModelConfig) -> Tuple[int, int]:
    """(segments, SSM layers a segment)."""
    per = cfg.attn_every
    if per <= 0 or cfg.num_layers % per:
        raise ValueError(f"hybrid: {cfg.num_layers} layers do not split into "
                         f"segments of attn_every={per}")
    return cfg.num_layers // per, per


def init(gen: torch.Generator, cfg: ModelConfig, device,
         dtype=None) -> Params:
    """Fresh parameters drawn from ``gen`` on ``device``, in
    ``cfg.param_dtype`` or each leaf cast to ``dtype`` as it is drawn
    (``transformer.init``)."""
    dtype = L.to_dtype(dtype or cfg.param_dtype)
    params: Params = {
        "embed": {"table": L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                        dtype, device)},
        "mamba": S.init_mamba_block(gen, cfg, dtype, device, cfg.num_layers),
        "shared_attn": T.init_block(gen, cfg, dtype, device),
        "final_norm": L.init_rmsnorm((cfg.d_model,), dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                            dtype, device)}
    return params


def _attn_apply(bp: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, return_kv: bool = False):
    """The shared block over a full sequence -> x, or (x, (k, v))."""
    h = L.apply_norm(bp["attn_norm"], x, cfg)
    attn_out, kv = L.attention(bp["attn"], h, positions, cfg,
                               window=cfg.sliding_window, return_kv=True)
    x = x + attn_out
    h = L.apply_norm(bp["mlp_norm"], x, cfg)
    x = x + L.apply_mlp(bp["mlp"], h, cfg)
    return (x, kv) if return_kv else x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            order: Optional[Sequence[int]] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, T) -> (logits (B, T, V), aux): the JAX family's
    ``return_aux`` form, aux a 0-d fp32 0 (no MoE layer).

    ``order`` walks the ``"mamba"`` tower in that order (CheckFree+'s
    swapped stages); the shared block still runs after every
    ``attn_every`` positions of the walk, as after JAX's permuted tower.
    """
    nseg, per = _nseg(cfg)
    positions = T.token_positions(tokens)
    x = S.embed_tokens(params, cfg, tokens)
    mamba = T.unstack(params["mamba"], cfg.num_layers)
    walk = T.layer_order(cfg.num_layers, order)
    for seg in range(nseg):
        for i in walk[seg * per:(seg + 1) * per]:
            x = x + S.mamba_block(mamba[i], x, cfg)
        x = _attn_apply(params["shared_attn"], x, positions, cfg)
    logits = S.logits_from_hidden(params, cfg, x)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device,
               dtype=None) -> Params:
    dtype = L.to_dtype(dtype or cfg.dtype)
    nseg, _ = _nseg(cfg)
    kv = (nseg, batch, capacity, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = S.init_cache(cfg, batch, capacity, device, dtype)
    cache["k"] = torch.zeros(kv, dtype=dtype, device=device)
    cache["v"] = torch.zeros(kv, dtype=dtype, device=device)
    return cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            capacity: int) -> Tuple[torch.Tensor, Params]:
    """Forward over the prompt -> (last-token logits (B, 1, V), cache).

    Each segment's K/V go into its slice of the KV cache as the dense
    prefill places them (a ring of the last ``window`` positions when the
    capacity equals the sliding window and the prompt is longer).
    """
    b, t = tokens.shape
    nseg, per = _nseg(cfg)
    slots = T.kv_slots(t, capacity, cfg.sliding_window, tokens.device)
    positions = T.token_positions(tokens)
    cache = init_cache(cfg, b, capacity, tokens.device)
    x = S.embed_tokens(params, cfg, tokens)
    mamba = T.unstack(params["mamba"], cfg.num_layers)
    for seg in range(nseg):
        x = S.prefill_layers(mamba, x, cfg, cache,
                             range(seg * per, (seg + 1) * per))
        x, (k, v) = _attn_apply(params["shared_attn"], x, positions, cfg,
                                return_kv=True)
        T.store_kv(cache, seg, k, v, slots)
    cache["pos"].fill_(t)
    return S.logits_from_hidden(params, cfg, x[:, -1:, :]), cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, *, window: int = 0,
                ) -> Tuple[torch.Tensor, Params]:
    """tokens: (B,) -> (logits (B, 1, V), cache).

    ``window`` as in ``transformer.decode_step``.  The cache's states and
    K/V are updated in place (the returned cache shares them); ``pos``
    advances by one.
    """
    nseg, per = _nseg(cfg)
    pos = cache["pos"]
    bp = params["shared_attn"]
    x = S.embed_tokens(params, cfg, tokens[:, None])
    mamba = T.unstack(params["mamba"], cfg.num_layers)
    for seg in range(nseg):
        x = S.decode_layers(mamba, x, cfg, cache,
                            range(seg * per, (seg + 1) * per))
        h = L.apply_norm(bp["attn_norm"], x, cfg)
        out, _, _ = L.attention_decode(bp["attn"], h, pos, cache["k"][seg],
                                       cache["v"][seg], cfg, window=window)
        x = x + out
        h = L.apply_norm(bp["mlp_norm"], x, cfg)
        x = x + L.apply_mlp(bp["mlp"], h, cfg)
    logits = S.logits_from_hidden(params, cfg, x)
    return logits, {**cache, "pos": pos + 1}
