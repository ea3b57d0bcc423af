"""Plain reference of a dense decoder (llama/mistral family: h2o-danube3).

Float32 PyTorch, no kernel, no cache, written from the published
description: token embedding; per layer RMSNorm, grouped-query attention
with rotary embeddings (split-half rotation, theta ``rope_theta``), a causal
mask and an optional sliding window, the output projection, RMSNorm and a
SwiGLU MLP, each with a residual; the final RMSNorm; an untied head.  The
parameters are the program's nested layout (layers stacked on axis 0):
``embed.table`` (V, d), ``blocks.{attn_norm,mlp_norm}.scale`` (L, d),
``blocks.attn.{wq,wk,wv,wo}`` (L, d, H*hd) / (L, H*hd, d),
``blocks.mlp.{w_gate,w_up}`` (L, d, ff), ``blocks.mlp.w_down`` (L, ff, d),
``final_norm.scale`` (d,), ``head.w`` (d, V).

Imports nothing of the program.  The configuration file's published keys
(``hidden_size``, ``num_attention_heads``, ...) give the sizes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from perfbench.lib import reftrain as R

TOWER = "blocks"


def dims(conf: dict):
    d = conf["hidden_size"]
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // hq
    return d, hq, hkv, hd, conf["intermediate_size"], conf["vocab_size"]


def num_layers(conf: dict) -> int:
    return int(conf["num_hidden_layers"])


def leaf_specs(conf: dict):
    """(path, shape, draw) of every leaf: matrices N(0, 1/fan_in), the
    embedding N(0, 0.02^2), norm scales 1."""
    d, hq, hkv, hd, ff, vocab = dims(conf)
    n = num_layers(conf)
    mat = lambda fan_in: R.normal(1.0 / math.sqrt(fan_in))  # noqa: E731
    return [
        (("embed", "table"), (vocab, d), R.normal(0.02)),
        (("blocks", "attn_norm", "scale"), (n, d), R.constant(1.0)),
        (("blocks", "attn", "wq"), (n, d, hq * hd), mat(d)),
        (("blocks", "attn", "wk"), (n, d, hkv * hd), mat(d)),
        (("blocks", "attn", "wv"), (n, d, hkv * hd), mat(d)),
        (("blocks", "attn", "wo"), (n, hq * hd, d), mat(hq * hd)),
        (("blocks", "mlp_norm", "scale"), (n, d), R.constant(1.0)),
        (("blocks", "mlp", "w_gate"), (n, d, ff), mat(d)),
        (("blocks", "mlp", "w_up"), (n, d, ff), mat(d)),
        (("blocks", "mlp", "w_down"), (n, ff, d), mat(ff)),
        (("final_norm", "scale"), (d,), R.constant(1.0)),
        (("head", "w"), (d, vocab), mat(d)),
    ]


def matmul_params(conf: dict) -> int:
    """Parameters that multiply each token: the layers' projections and the
    head (the embedding is a lookup)."""
    d, hq, hkv, hd, ff, vocab = dims(conf)
    per_layer = 2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * ff
    return num_layers(conf) * per_layer + d * vocab


def attention_shapes(conf: dict, batch: int, seq: int) -> List[Dict[str, Any]]:
    """One entry a layer's attention call in a step of ``batch`` x ``seq``
    (the keyword arguments of the cost functions)."""
    d, hq, hkv, hd, _, _ = dims(conf)
    window = int(conf.get("sliding_window") or 0)
    return [dict(b=batch, hq=hq, hkv=hkv, s=seq, sk=seq, d=hd, causal=True,
                 window=window)] * num_layers(conf)


def program_fields(conf: dict) -> Dict[str, Any]:
    """The program's configuration fields that must equal the file's."""
    d, hq, hkv, hd, ff, vocab = dims(conf)
    return {"arch_type": "dense", "num_layers": num_layers(conf),
            "d_model": d, "num_heads": hq, "num_kv_heads": hkv,
            "head_dim": hd, "d_ff": ff, "vocab_size": vocab,
            "act": conf["hidden_act"], "rmsnorm_eps": conf["rms_norm_eps"],
            "rope_theta": conf["rope_theta"],
            "sliding_window": int(conf.get("sliding_window") or 0),
            "tie_embeddings": bool(conf["tie_word_embeddings"]),
            "use_qk_norm": False, "gated_mlp": True, "norm": "rmsnorm",
            "use_rope": True, "embed_scale": False, "logit_softcap": 0.0}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def embed(params, tokens: torch.Tensor, conf: dict) -> torch.Tensor:
    return params["embed"]["table"][tokens.long()]


def embed_backward(grads, tokens: torch.Tensor, g: torch.Tensor,
                   conf: dict) -> None:
    grads["embed"]["table"].index_add_(0, tokens.reshape(-1).long(),
                                       g.reshape(-1, g.shape[-1]))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): positions 0..S-1, split-half rotation; the angles
    reckoned in float64."""
    s, dim = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                         device=x.device) / dim)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos = ang.cos().float()[None, :, None, :]
    sin = ang.sin().float()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int, ops: R.Ops) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D): softmax over
    the keys j <= i (and j > i - window), in float32."""
    b, s, hq, hd = q.shape
    rep = hq // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(rep, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(rep, dim=1)
    scores = ops.mm(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    i = torch.arange(s, device=q.device)
    hidden = i[None, :] > i[:, None]
    if window > 0:
        hidden = hidden | (i[None, :] <= i[:, None] - window)
    scores.masked_fill_(hidden, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return ops.mm(probs, vh).transpose(1, 2)


def block(lp, x: torch.Tensor, conf: dict, ops: R.Ops) -> torch.Tensor:
    """One layer's two residual branches, summed: the layer adds them to
    its input."""
    d, hq, hkv, hd, _, _ = dims(conf)
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    b, s, _ = x.shape
    a = lp["attn"]
    h = R.rmsnorm(x, lp["attn_norm"]["scale"], eps)
    q = ops.mm(h, a["wq"]).view(b, s, hq, hd)
    k = ops.mm(h, a["wk"]).view(b, s, hkv, hd)
    v = ops.mm(h, a["wv"]).view(b, s, hkv, hd)
    o = attention(rope(q, theta), rope(k, theta), v,
                  int(conf.get("sliding_window") or 0), ops)
    attn = ops.mm(o.reshape(b, s, hq * hd), a["wo"])
    h = R.rmsnorm(x + attn, lp["mlp_norm"]["scale"], eps)
    mlp = lp["mlp"]
    act = F.silu(ops.mm(h, mlp["w_gate"])) * ops.mm(h, mlp["w_up"])
    return attn + ops.mm(act, mlp["w_down"])


def loss_tail(params, x: torch.Tensor, labels: torch.Tensor, conf: dict,
              ops: R.Ops) -> torch.Tensor:
    h = R.rmsnorm(x, params["final_norm"]["scale"], conf["rms_norm_eps"])
    w = (params["embed"]["table"].t() if conf["tie_word_embeddings"]
         else params["head"]["w"])
    return R.cross_entropy(ops.mm(h, w), labels)
