"""Tiny cells for the CPU tests: the two families at width 64, on the
benchmark's own traffic mixes cut to batch 4 x 32 tokens."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

NUMBERS = ("loss_gap", "grad_gap", "omega_gap", "update_gap")

DENSE = {
    "name": "tiny-dense", "family": "dense", "hidden_size": 64,
    "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 4,
    "vocab_size": 256, "hidden_act": "silu", "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "sliding_window": 4096,
    "tie_word_embeddings": False,
    "program": {"arch": "h2o-danube-3-4b", "stages": 4, "replace": {
        "num_layers": 4, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 16, "d_ff": 128, "vocab_size": 256}}}

SSM = {
    "name": "tiny-ssm", "family": "ssm", "d_model": 64, "n_layer": 8,
    "vocab_size": 256, "d_state": 16, "d_conv": 4, "expand": 2,
    "headdim": 16, "ngroups": 1, "chunk_size": 8, "rms_norm_eps": 1e-5,
    "tie_embeddings": True,
    "program": {"arch": "mamba2-1.3b", "stages": 8, "replace": {
        "num_layers": 8, "d_model": 64, "vocab_size": 256,
        "ssm": {"state_dim": 16, "head_dim": 16, "chunk_size": 8}}}}

MIXES = {"dense": "checkfree.train4k.churn16",
         "ssm": "checkfree_plus.train512.churn16"}


def conf(family: str, dtype: str = "bfloat16") -> dict:
    c = copy.deepcopy(DENSE if family == "dense" else SSM)
    c["program"]["replace"]["dtype"] = dtype
    return c


def mix(name: str, batch: int = 4, seq: int = 32) -> dict:
    with open(ROOT / "perfbench" / "traffic" / f"{MIXES[name]}.json") as f:
        m = json.load(f)
    m.update(batch=batch, seq=seq)
    return m


def limits(value: float) -> dict:
    return {"limits": {k: value for k in NUMBERS}}


def cell(family: str, mix_name: str = None, dtype: str = "float32",
         limit: float = 1e-4):
    from perfbench.lib import registry
    return registry.cell_from_files(
        f"tiny-{family}", conf(family, dtype), mix(mix_name or family),
        limits(limit))
