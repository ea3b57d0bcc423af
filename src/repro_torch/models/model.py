"""Model facade of the PyTorch port.

``build_model(cfg, ...)`` returns a :class:`Model`, an ``nn.Module`` that owns
the serving parameters and exposes init / apply / loss / init_cache /
prefill / decode_step with the JAX package's batch convention
(``{"tokens": (B, S) int, "labels": (B, S) int}``, with ``"frames"`` (B, F,
d) for the encoder-decoder family and ``"patches"`` (B, P, D_PATCH) for the
VLM family).  ``loss`` takes an
explicit tree of fp32 master parameters (training); a trainer builds the
facade with ``weights=False`` so that no second copy of the weights is made.
The parameters keep the JAX layout: the same nested keys, decoder blocks
stacked on axis 0, so ``state_dict`` keys read ``tree.blocks.attn.wq`` and
``repro_torch.convert`` carries JAX parameters across one to one.

Every family of the configs is ported, to serve and to train: dense, MoE,
ssm, hybrid, encoder-decoder and VLM.  ``loss`` dispatches by family as the
JAX ``Model.loss`` does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as H
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]

# the family modules: init, forward, init_cache, prefill, decode_step
_FAMILIES = {"dense": T, "moe": T, "ssm": S, "hybrid": H, "encdec": ED,
             "vlm": V}
# the batch keys a family's forward and prefill take beside the tokens
_INPUTS = {"encdec": ("frames",), "vlm": ("patches",)}


def _to_module(tree: Params) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _to_module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _to_tree(m: nn.Module) -> Params:
    tree: Params = dict(m.named_parameters(recurse=False))
    for k, child in m.named_children():
        tree[k] = _to_tree(child)
    return tree


class Model(nn.Module):
    """Owns the parameters of one model, in ``cfg.dtype``, on ``device``.

    ``params`` is a nested dict of tensors (the family's ``init`` or
    ``repro_torch.convert.params_from_numpy``); without it the parameters are
    drawn from ``generator`` (seed 0 on ``device`` when none is given), each
    leaf cast to ``cfg.dtype`` as soon as it is drawn, so that the whole tree
    is never held in ``cfg.param_dtype`` (deepseek-moe-16b's fp32 tree, 67.5
    GB, would not fit the card beside its bf16 copy).  They are cast to
    ``cfg.dtype`` once, here: the JAX code recasts its fp32 parameters on
    every call (``L.cast_tree``), which gives the same values.
    With ``weights=False`` the model holds no parameters: ``init`` and
    ``loss`` work, the serving methods need weights.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 weights: bool = True):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.family = _FAMILIES[cfg.arch_type]
        self.device = torch.device(device)
        if not weights:
            if params is not None:
                raise ValueError("weights=False takes no params")
            self.tree = nn.Module()
            return
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = self.init(generator, dtype=cfg.dtype)
        params = L.cast_tree(params, cfg.dtype)
        self.tree = _to_module(_move(params, self.device))

    @property
    def params(self) -> Params:
        """The parameters as the nested dict the layer functions take."""
        tree = _to_tree(self.tree)
        if not tree:
            raise RuntimeError("this Model was built with weights=False: "
                               "pass parameters to loss(), or build it with "
                               "weights to serve")
        return tree

    def init(self, generator: torch.Generator, dtype=None) -> Params:
        """A fresh parameter tree drawn from ``generator``, in
        ``cfg.param_dtype``, or with each leaf cast to ``dtype`` as it is
        drawn (the values of casting the whole tree afterwards)."""
        return self.family.init(generator, self.cfg, self.device, dtype)

    def inputs(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The batch's inputs beside the tokens that the family takes: the
        encoder-decoder's ``frames``, the VLM's ``patches``."""
        return {k: batch[k] for k in _INPUTS.get(self.cfg.arch_type, ())}

    def loss(self, params: Params, batch: Batch, *,
             order: Optional[Sequence[int]] = None, remat: bool = False,
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean token cross-entropy of ``batch`` -> (loss, {"ce", "aux"}).

        ``params`` is an explicit tree, normally the fp32 masters: they are
        cast to ``cfg.dtype`` inside the graph (as the JAX family forwards
        do), so their gradients land in fp32.  Runs with autograd.
        ``order`` walks the family's staged tower in that order (CheckFree+'s
        swapped stages).  aux is the MoE layers' load-balance loss summed
        over the layers (0 for the other families), added with weight
        ``cfg.moe.router_aux_coef``.  The VLM's P patch positions carry no
        loss: as JAX drops their logits, they are not unembedded.
        ``remat`` checkpoints the family's blocks (``launch.perf``), as the
        JAX ``Model.loss(remat=True)``: every layer (dense, MoE, ssm), every
        segment (hybrid), the decoder blocks alone keeping nothing
        (encoder-decoder), the decoder's (VLM).
        """
        cfg = self.cfg
        kw = self.inputs(batch)
        if cfg.arch_type == "vlm":
            kw["prefix_logits"] = False
        logits, aux = self.family.forward(L.cast_tree(params, cfg.dtype), cfg,
                                          batch["tokens"], order=order,
                                          remat=remat, **kw)
        ce = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
        return ce + cfg.moe.router_aux_coef * aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def apply(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (logits, aux_loss); aux is 0 but for
        the MoE family.

        Named after the JAX ``Model.apply``; it shadows ``nn.Module.apply``.
        """
        return self.family.forward(self.params, self.cfg, batch["tokens"],
                                   **self.inputs(batch))

    def init_cache(self, batch: int, capacity: int) -> Params:
        return self.family.init_cache(self.cfg, batch, capacity, self.device)

    @torch.no_grad()
    def prefill(self, batch: Batch, capacity: int) -> Tuple[torch.Tensor, Params]:
        return self.family.prefill(self.params, self.cfg, batch["tokens"],
                                   capacity, **self.inputs(batch))

    @torch.no_grad()
    def decode_step(self, cache: Params, tokens: torch.Tensor, *,
                    window: int = 0) -> Tuple[torch.Tensor, Params]:
        return self.family.decode_step(self.params, self.cfg, cache, tokens,
                                       window=window)


def _move(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _move(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_model(cfg: ModelConfig, params: Optional[Params] = None, *,
                device="cuda", generator: Optional[torch.Generator] = None,
                weights: bool = True) -> Model:
    return Model(cfg, params, device=device, generator=generator,
                 weights=weights)
