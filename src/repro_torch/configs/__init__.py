"""Architecture registry: ``get_config(arch_id)`` + reduced smoke variants.

A copy of ``repro.configs``, so that ``--arch`` ids and every config match
the JAX package's without importing it.  ``reduced(cfg)`` builds the
CPU-smoke variant (<= 2 layers, d_model <= 512, <= 4 experts).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.config import ModelConfig

from repro_torch.configs import (
    granite_moe_3b_a800m, deepseek_moe_16b, h2o_danube_3_4b, gemma_2b,
    zamba2_2p7b, qwen3_4b, internvl2_76b, whisper_large_v3, mamba2_1p3b,
    deepseek_coder_33b, paper_llama)

_MODULES = {
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "deepseek-moe-16b": deepseek_moe_16b,
    "h2o-danube-3-4b": h2o_danube_3_4b,
    "gemma-2b": gemma_2b,
    "zamba2-2.7b": zamba2_2p7b,
    "qwen3-4b": qwen3_4b,
    "internvl2-76b": internvl2_76b,
    "whisper-large-v3": whisper_large_v3,
    "mamba2-1.3b": mamba2_1p3b,
    "deepseek-coder-33b": deepseek_coder_33b,
}

ARCHS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
NUM_STAGES: Dict[str, int] = {k: m.NUM_STAGES for k, m in _MODULES.items()}

PAPER_MODELS: Dict[str, ModelConfig] = {
    "paper-llama-124m": paper_llama.SMALL,
    "paper-llama-500m": paper_llama.MEDIUM,
    "paper-llama-1.5b": paper_llama.LARGE,
}
PAPER_STAGES = {
    "paper-llama-124m": paper_llama.SMALL_STAGES,
    "paper-llama-500m": paper_llama.MEDIUM_STAGES,
    "paper-llama-1.5b": paper_llama.LARGE_STAGES,
}


def arch_ids() -> List[str]:
    return list(ARCHS.keys())


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    raise KeyError(f"unknown arch '{name}'; known: "
                   f"{sorted(ARCHS) + sorted(PAPER_MODELS)}")


def get_stages(name: str) -> int:
    return {**NUM_STAGES, **PAPER_STAGES}[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model <= 512, <= 4 experts."""
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=256,
    )
    if cfg.arch_type != "ssm":
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 1 if cfg.num_kv_heads == 1 else \
            (4 if cfg.num_kv_heads == cfg.num_heads else 2)
        kw["head_dim"] = 64
        kw["d_ff"] = min(cfg.d_ff, 512) if cfg.d_ff else 0
    if cfg.arch_type == "moe":
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff_expert=64)
    if cfg.arch_type in ("ssm", "hybrid"):
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=min(cfg.ssm.state_dim, 16), head_dim=32,
            chunk_size=16)
    if cfg.arch_type == "hybrid":
        kw["attn_every"] = 1
    if cfg.arch_type == "encdec":
        kw["num_encoder_layers"] = 2
        kw["encoder_seq_len"] = 16
    if cfg.arch_type == "vlm":
        kw["num_patches"] = 8
    out = cfg.replace(**kw)
    out.validate()
    return out
