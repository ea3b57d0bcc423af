"""VLM family (internvl2-76b's language backbone), in PyTorch.

The counterpart of ``repro.models.vlm``.  The vision tower is a stub, as in
the JAX package: the inputs are (B, P, ``D_PATCH``) patch embeddings, which
an MLP projector maps into the residual stream of a llama-family decoder
(``models.transformer``) as a prefix of P positions before the tokens.  The
projector is replicated like the (de)embedding under CheckFree+: only the
``blocks`` tower is staged.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.data.pipeline import D_PATCH
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: ModelConfig, device,
         dtype=None) -> Params:
    """The decoder's parameters (``transformer.init``) and the projector's
    {w1 (D_PATCH, d), w2 (d, d)}, each leaf in ``dtype`` as it is drawn."""
    params = T.init(gen, cfg, device, dtype)
    dtype = L.to_dtype(dtype or cfg.param_dtype)
    params["projector"] = {
        "w1": L.dense_init(gen, (D_PATCH, cfg.d_model), dtype, device),
        "w2": L.dense_init(gen, (cfg.d_model, cfg.d_model), dtype, device)}
    return params


def project(params: Params, patches: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """patches (B, P, D_PATCH) -> (B, P, d).  The GELU is the tanh form:
    ``jax.nn.gelu``'s default (``approximate=True``), which the JAX
    projector calls."""
    p = params["projector"]
    h = F.gelu(patches.to(L.to_dtype(cfg.dtype)) @ p["w1"], approximate="tanh")
    return h @ p["w2"]


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            patches: torch.Tensor, order: Optional[Sequence[int]] = None,
            prefix_logits: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S), patches (B, P, D_PATCH) -> (logits, aux).  The logits
    cover the P + S positions, as JAX's; ``prefix_logits=False`` unembeds
    only the S token positions (the same values: the loss drops the patch
    positions, so their P x V logits a row are never formed)."""
    embeds = project(params, patches, cfg)
    return T.forward(params, cfg, tokens, order=order, inputs_embeds=embeds,
                     prefix_logits=prefix_logits)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device,
               dtype=None) -> Params:
    return T.init_cache(cfg, batch, capacity, device, dtype)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            capacity: int, *, patches: torch.Tensor,
            ) -> Tuple[torch.Tensor, Params]:
    """The patches' prefix, then the prompt: the cache covers P + S."""
    return T.prefill(params, cfg, tokens, capacity,
                     inputs_embeds=project(params, patches, cfg))


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, *, window: int = 0,
                ) -> Tuple[torch.Tensor, Params]:
    return T.decode_step(params, cfg, cache, tokens, window=window)
