"""Encoder-decoder family (whisper-large-v3's backbone), in PyTorch.

The counterpart of ``repro.models.encdec``.  The audio frontend is a stub,
as in the JAX package: the inputs are (B, F, d) frame embeddings, F =
``cfg.encoder_seq_len`` (1500 for whisper).  A bidirectional encoder, then a
causal decoder whose blocks also attend to the encoder's states
(cross-attention); layernorm, a plain GELU MLP, learned absolute positions
and no rope anywhere, the token embedding tied to the unembedding.

Every full-sequence attention runs through ``kernels.ops.flash_attention``:
the encoder's without a mask (F x F), the decoder's self-attention causal,
and its cross-attention over the F encoder keys (Sq != Sk, full), so on the
card all three run the hand-written flash kernels, forward and backward.
Decode attends to the cached K/V in plain PyTorch, as the JAX code runs
``_sdpa`` there.

Blocks are stacked on axis 0 (``enc_blocks``, ``dec_blocks``) and walked as
views (``transformer.unstack``).  The staged tower is the encoder's: the
JAX trainer partitions ``towers(cfg)[0]``, ``enc_blocks``
(``repro/core/stages.py``), so ``order`` (CheckFree+'s swapped stages)
permutes the encoder's layers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_order, unstack

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: ModelConfig, device,
         dtype=None) -> Params:
    """Fresh parameters in ``cfg.param_dtype``, or each leaf cast to
    ``dtype`` as it is drawn (``transformer.init`` says why)."""
    dtype = L.to_dtype(dtype or cfg.param_dtype)
    d, ne, nd = cfg.d_model, cfg.num_encoder_layers, cfg.num_layers

    def norm(n):
        return L.init_norm_cfg((n, d) if n else (d,), dtype, device, cfg)

    return {
        "enc_pos": {"table": L.embed_init(gen, (cfg.encoder_seq_len, d),
                                          dtype, device)},
        "enc_blocks": {
            "attn_norm": norm(ne),
            "attn": L.init_attention(gen, cfg, dtype, device, ne),
            "mlp_norm": norm(ne),
            "mlp": L.init_mlp_cfg(gen, cfg, dtype, device, ne)},
        "enc_final_norm": norm(0),
        "embed": {"table": L.embed_init(gen, (cfg.vocab_size, d), dtype,
                                        device)},
        "dec_pos": {"table": L.embed_init(gen, (cfg.max_seq_len, d), dtype,
                                          device)},
        "dec_blocks": {
            "self_norm": norm(nd),
            "self_attn": L.init_attention(gen, cfg, dtype, device, nd),
            "cross_norm": norm(nd),
            "cross_attn": L.init_attention(gen, cfg, dtype, device, nd),
            "mlp_norm": norm(nd),
            "mlp": L.init_mlp_cfg(gen, cfg, dtype, device, nd)},
        "final_norm": norm(0),
    }


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           order: Optional[Sequence[int]] = None) -> torch.Tensor:
    """frames (B, F, d), the stubbed frontend's output -> encoder states.

    ``order``: the encoder's layers in that order (a permutation)."""
    b, f, _ = frames.shape
    dt = L.to_dtype(cfg.dtype)
    x = frames.to(dt) + params["enc_pos"]["table"][None, :f].to(dt)
    positions = torch.arange(f, device=frames.device).expand(b, f)
    blocks = unstack(params["enc_blocks"], cfg.num_encoder_layers)
    for i in layer_order(cfg.num_encoder_layers, order):
        bp = blocks[i]
        h = L.apply_norm(bp["attn_norm"], x, cfg)
        x = x + L.attention(bp["attn"], h, positions, cfg, causal=False,
                            use_rope=False)
        h = L.apply_norm(bp["mlp_norm"], x, cfg)
        x = x + L.apply_mlp(bp["mlp"], h, cfg)
    return L.apply_norm(params["enc_final_norm"], x, cfg)


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = L.embed(params["embed"], tokens).to(L.to_dtype(cfg.dtype))
    return x + params["dec_pos"]["table"][positions].to(x.dtype)


def _dec_block(bp: Params, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, enc_out: torch.Tensor):
    """One decoder block -> (x, (self k, self v, cross k, cross v))."""
    h = L.apply_norm(bp["self_norm"], x, cfg)
    so, (sk, sv) = L.attention(bp["self_attn"], h, positions, cfg,
                               use_rope=False, return_kv=True)
    x = x + so
    h = L.apply_norm(bp["cross_norm"], x, cfg)
    co, (ck, cv) = L.attention(bp["cross_attn"], h, positions, cfg,
                               kv=enc_out, use_rope=False, return_kv=True)
    x = x + co
    h = L.apply_norm(bp["mlp_norm"], x, cfg)
    return x + L.apply_mlp(bp["mlp"], h, cfg), (sk, sv, ck, cv)


def _decoder(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             enc_out: torch.Tensor, cache: Optional[Params] = None,
             ) -> torch.Tensor:
    """The decoder over a full sequence -> its final hidden states.  With
    ``cache``, each layer's self K/V go into slots 0..S-1 of it and the
    layer's cross K/V beside them."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, cfg, tokens, positions)
    for i, bp in enumerate(unstack(params["dec_blocks"], cfg.num_layers)):
        x, (sk, sv, ck, cv) = _dec_block(bp, x, positions, cfg, enc_out)
        if cache is not None:
            cache["k"][i, :, :s] = sk
            cache["v"][i, :, :s] = sv
            cache["ck"][i] = ck
            cache["cv"][i] = cv
    return x


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return L.unembed(params["embed"], L.apply_norm(params["final_norm"], x,
                                                   cfg))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: torch.Tensor, order: Optional[Sequence[int]] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) decoder inputs, frames (B, F, d) -> (logits (B, S, V),
    aux): aux is a 0-d fp32 0, as the JAX family's.  ``order`` walks the
    encoder's layers in that order."""
    x = _decoder(params, cfg, tokens, encode(params, cfg, frames, order=order))
    logits = _logits(params, cfg, x)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device,
               dtype=None) -> Params:
    """Self K/V of ``capacity`` positions and the cross K/V of the F
    encoder frames, a layer each."""
    dtype = L.to_dtype(dtype or cfg.dtype)
    lead = (cfg.num_layers, batch)
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)

    def zeros(n):
        return torch.zeros((*lead, n, *tail), dtype=dtype, device=device)

    return {"k": zeros(capacity), "v": zeros(capacity),
            "ck": zeros(cfg.encoder_seq_len), "cv": zeros(cfg.encoder_seq_len),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            capacity: int, *, frames: torch.Tensor,
            ) -> Tuple[torch.Tensor, Params]:
    """Encode the frames, run the decoder over the prompt -> (last-token
    logits (B, 1, V), cache).  The cross K/V are computed once, here."""
    b, s = tokens.shape
    if capacity < s:
        raise ValueError(f"prefill: prompt of {s} tokens does not fit a "
                         f"cache of capacity {capacity}")
    cache = init_cache(cfg, b, capacity, tokens.device)
    x = _decoder(params, cfg, tokens, encode(params, cfg, frames), cache)
    cache["pos"].fill_(s)
    return _logits(params, cfg, x[:, -1:, :]), cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, *, window: int = 0,
                ) -> Tuple[torch.Tensor, Params]:
    """tokens: (B,) next input token -> (logits (B, 1, V), cache).

    Self-attention against the growing cache (written in place at ``pos``),
    cross-attention against the prefill's cross K/V, no rope; ``pos``
    advances by one in the returned cache, as the other families'.
    ``window`` is taken for the common signature: whisper's cache is full.
    """
    if window:
        raise ValueError("the encoder-decoder family serves a full cache: "
                         f"window {window}")
    pos = cache["pos"]
    x = _embed(params, cfg, tokens[:, None], pos[:, None])
    for i, bp in enumerate(unstack(params["dec_blocks"], cfg.num_layers)):
        h = L.apply_norm(bp["self_norm"], x, cfg)
        out, _, _ = L.attention_decode(bp["self_attn"], h, pos, cache["k"][i],
                                       cache["v"][i], cfg, use_rope=False)
        x = x + out
        h = L.apply_norm(bp["cross_norm"], x, cfg)
        x = x + L.cross_attention_decode(bp["cross_attn"], h, cache["ck"][i],
                                         cache["cv"][i], cfg)
        h = L.apply_norm(bp["mlp_norm"], x, cfg)
        x = x + L.apply_mlp(bp["mlp"], h, cfg)
    return _logits(params, cfg, x), {**cache, "pos": pos + 1}
