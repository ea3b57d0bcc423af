"""Decoder-only transformer family, in PyTorch: dense (llama / qwen3 /
gemma / danube / deepseek-coder and the paper's LLaMa sizes) and MoE
(granite-moe, deepseek-moe: ``models.moe`` in place of the MLP).

The counterpart of ``repro.models.transformer`` for ``arch_type`` "dense"
and "moe".
Blocks are stacked on axis 0 as in the JAX package; where JAX scans the
stack with ``jax.lax.scan``, a Python loop walks views of the stacked
tensors (no copies).  Three entry points:

* :func:`forward`      — full-sequence forward (causal), in an optional
                         layer order (CheckFree+'s swapped stages).
* :func:`prefill`      — full-sequence forward that also fills the KV cache.

Both take optional ``inputs_embeds``, a (B, P, d) prefix of embeddings
prepended to the tokens' (the VLM family's projected patches).
* :func:`decode_step`  — one-token decode against a (possibly ring) KV cache.

Parameters arrive already in ``cfg.dtype``: ``models.model.Model`` casts its
serving weights once when it is built, and ``Model.loss`` casts the fp32
training masters inside the graph on every call, as the JAX code does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, dtype, device,
               layers: Optional[int] = None) -> Params:
    """A decoder block's parameters: ``layers`` blocks stacked on axis 0, or
    one block with no layer axis (the hybrid family's shared block)."""
    n = () if layers is None else (layers,)
    return {
        "attn_norm": L.init_norm_cfg((*n, cfg.d_model), dtype, device, cfg),
        "attn": L.init_attention(gen, cfg, dtype, device, layers),
        "mlp_norm": L.init_norm_cfg((*n, cfg.d_model), dtype, device, cfg),
        "mlp": (MOE.init_moe_layer(gen, cfg, dtype, device, layers)
                if cfg.arch_type == "moe"
                else L.init_mlp_cfg(gen, cfg, dtype, device, layers)),
    }


def init(gen: torch.Generator, cfg: ModelConfig, device,
         dtype=None) -> Params:
    """Fresh parameters drawn from ``gen`` on ``device``, in
    ``cfg.param_dtype`` or, given ``dtype``, each leaf cast to it as soon as
    it is drawn (the same values as casting the whole tree afterwards,
    without ever holding the whole tree in ``cfg.param_dtype``)."""
    dtype = L.to_dtype(dtype or cfg.param_dtype)
    params: Params = {
        "embed": {"table": L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                        dtype, device)},
        "blocks": init_block(gen, cfg, dtype, device, cfg.num_layers),
        "final_norm": L.init_norm_cfg((cfg.d_model,), dtype, device, cfg),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                            dtype, device)}
    if not cfg.use_rope:
        params["pos_embed"] = {"table": L.embed_init(
            gen, (cfg.max_seq_len, cfg.d_model), dtype, device)}
    return params


def swa_flags(cfg: ModelConfig) -> List[bool]:
    """Which layers use sliding-window attention."""
    if cfg.sliding_window > 0:
        return [i % max(cfg.swa_every, 1) == 0 for i in range(cfg.num_layers)]
    return [False] * cfg.num_layers


def unstack(tree: Any, n: int) -> List[Any]:
    """The ``n`` layers of a tree stacked on axis 0, as views.

    One ``unbind`` per leaf: under autograd its backward stacks the layers'
    gradients in one operation, where indexing each layer would build a
    full-size gradient per layer.
    """
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _mlp_or_moe(bp: Params, h: torch.Tensor, cfg: ModelConfig):
    """(out, aux): the MoE layer's load-balance loss, 0 for a dense MLP."""
    if cfg.arch_type == "moe":
        return MOE.moe_mlp(bp["mlp"], h, cfg)
    return L.apply_mlp(bp["mlp"], h, cfg), 0.0


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    x = L.embed(params["embed"], tokens, scale=cfg.embed_scale)
    x = x.to(L.to_dtype(cfg.dtype))
    if not cfg.use_rope:
        x = x + params["pos_embed"]["table"][positions].to(x.dtype)
    return x


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, cfg.logit_softcap)
    return L.unembed_w(params["head"], x, cfg.logit_softcap)


def _block(bp: Params, x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, window: int):
    """One decoder block over a full sequence -> (x, (k, v), aux)."""
    h = L.apply_norm(bp["attn_norm"], x, cfg)
    attn_out, kv = L.attention(bp["attn"], h, positions, cfg, window=window,
                               return_kv=True)
    x = x + attn_out
    h = L.apply_norm(bp["mlp_norm"], x, cfg)
    out, aux = _mlp_or_moe(bp, h, cfg)
    return x + out, kv, aux


def token_positions(tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) positions 0..S-1 of a prompt batch."""
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)


def embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 inputs_embeds: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x (B, P + S, d), positions (B, P + S)): the tokens' embeddings
    after the ``inputs_embeds`` prefix of P positions (none by default);
    the tokens sit at positions P..P+S-1, as in the JAX ``forward``."""
    if inputs_embeds is None:
        positions = token_positions(tokens)
        return embed_tokens(params, cfg, tokens, positions), positions
    b, s = tokens.shape
    pfx = inputs_embeds.shape[1]
    positions = torch.arange(s + pfx, device=tokens.device).expand(b, s + pfx)
    x = embed_tokens(params, cfg, tokens, positions[:, pfx:])
    return torch.cat([inputs_embeds.to(x.dtype), x], dim=1), positions


def layer_order(num_layers: int,
                order: Optional[Sequence[int]]) -> List[int]:
    """The layers a forward walks: ``order``, a permutation of
    ``range(num_layers)`` (CheckFree+'s swapped stages), or in order."""
    order = list(range(num_layers)) if order is None else list(order)
    if sorted(order) != list(range(num_layers)):
        raise ValueError(f"order {order} is no permutation of the "
                         f"{num_layers} layers")
    return order


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            order: Optional[Sequence[int]] = None,
            inputs_embeds: Optional[torch.Tensor] = None,
            prefix_logits: bool = True,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V), aux): the JAX family's
    ``return_aux`` form, aux the MoE layers' load-balance losses summed over
    the layers in the order they ran (a 0-d fp32 0 for dense).

    ``order`` runs the tower's layers in that order (a permutation of
    ``range(num_layers)``); position i keeps its own sliding-window flag.
    It is the counterpart of gathering a permuted tower
    (``repro/core/trainer.py:_permute_tower``): the same values without
    copying the tower, and autograd sums each layer's gradients into its own
    slice whichever position ran it.  With ``inputs_embeds`` the logits
    cover the prefix too, (B, P + S, V), unless ``prefix_logits`` is False.
    """
    x, positions = embed_inputs(params, cfg, tokens, inputs_embeds)
    blocks = unstack(params["blocks"], cfg.num_layers)
    aux = 0.0
    for i, swa in zip(layer_order(cfg.num_layers, order), swa_flags(cfg)):
        x, _, a = _block(blocks[i], x, positions, cfg,
                         cfg.sliding_window if swa else 0)
        aux = aux + a
    if inputs_embeds is not None and not prefix_logits:
        x = x[:, inputs_embeds.shape[1]:]
    logits = logits_from_hidden(params, cfg, x)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, capacity: int, device,
               dtype=None) -> Params:
    dtype = L.to_dtype(dtype or cfg.dtype)
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def kv_slots(s: int, capacity: int, window: int,
             device) -> Optional[torch.Tensor]:
    """Where a prompt of ``s`` tokens puts its K/V in a cache of
    ``capacity`` slots: None for slots 0..s-1; when the capacity equals the
    sliding window and the prompt is longer, the ring slots p % window of
    the last ``window`` positions p."""
    if window > 0 and capacity == window and s > window:
        return torch.arange(s - window, s, device=device) % window
    if capacity < s:
        raise ValueError(f"prefill: prompt of {s} tokens does not fit a "
                         f"cache of capacity {capacity}")
    return None


def store_kv(cache: Params, i: int, k: torch.Tensor, v: torch.Tensor,
             slots: Optional[torch.Tensor]) -> None:
    """Layer (or segment) ``i``'s prompt K/V (B, S, nkv, D) into the cache."""
    if slots is None:
        cache["k"][i, :, :k.shape[1]] = k
        cache["v"][i, :, :v.shape[1]] = v
    else:
        cache["k"][i][:, slots] = k[:, -slots.numel():]
        cache["v"][i][:, slots] = v[:, -slots.numel():]


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            capacity: int, *, inputs_embeds: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Params]:
    """Causal forward over the prompt -> (last-token logits (B, 1, V), cache).

    Each layer's K/V go straight into a fixed-capacity cache.  When the
    capacity equals the sliding window and the prompt is longer, the cache is
    a ring holding the last ``window`` positions, absolute position p at slot
    p % window.  ``inputs_embeds``: a (B, P, d) prefix; the cache then covers
    P + S positions.
    """
    b = tokens.shape[0]
    x, positions = embed_inputs(params, cfg, tokens, inputs_embeds)
    s = x.shape[1]
    window = cfg.sliding_window
    slots = kv_slots(s, capacity, window, tokens.device)
    cache = init_cache(cfg, b, capacity, tokens.device)
    blocks = unstack(params["blocks"], cfg.num_layers)
    for i, swa in enumerate(swa_flags(cfg)):
        x, (k, v), _ = _block(blocks[i], x, positions, cfg,
                              window if swa else 0)
        store_kv(cache, i, k, v, slots)
    cache["pos"].fill_(s)
    return logits_from_hidden(params, cfg, x[:, -1:, :]), cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, *, window: int = 0,
                ) -> Tuple[torch.Tensor, Params]:
    """tokens: (B,) next input token -> (logits (B, 1, V), cache).

    ``window``: 0 = full-cache attention; >0 = ring-buffer SWA with the cache
    capacity equal to the window.  The cache's K/V are updated in place (the
    returned cache shares them) and ``pos`` advances by one.  The caller
    keeps ``pos`` below the capacity of a full cache.
    """
    pos = cache["pos"]                         # (B,) absolute position to write
    x = embed_tokens(params, cfg, tokens[:, None], pos[:, None])
    for i, bp in enumerate(unstack(params["blocks"], cfg.num_layers)):
        h = L.apply_norm(bp["attn_norm"], x, cfg)
        out, _, _ = L.attention_decode(bp["attn"], h, pos, cache["k"][i],
                                       cache["v"][i], cfg, window=window)
        x = x + out
        h = L.apply_norm(bp["mlp_norm"], x, cfg)
        x = x + _mlp_or_moe(bp, h, cfg)[0]
    logits = logits_from_hidden(params, cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
