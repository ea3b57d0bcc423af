"""Plain reference of a Mamba-2 language model (state-spaces/mamba2).

Float32 PyTorch, no kernel, written from the published description
(arXiv:2405.21060, the Mamba2 block): token embedding; per layer RMSNorm,
one input projection into z, x, B, C and dt; a depthwise causal
convolution of width ``d_conv`` over (x, B, C) and SiLU; dt = softplus(dt +
dt_bias), A = -exp(A_log); the selective state space over the whole
sequence in its quadratic (attention-like) form, y_t = sum_{j <= t}
C_t . B_j exp(sum_{j < r <= t} dt_r A) dt_j x_j, plus D x_t; the gate
RMSNorm(y * SiLU(z)); the output projection; a residual.  Then the final
RMSNorm and the head tied to the embedding.  The quadratic form needs no
chunking, so it does not follow the program's chunked scan.

The parameters are the program's nested layout (layers stacked on axis 0):
``embed.table`` (V, d), ``blocks.norm.scale`` (L, d), ``blocks.w_in``
(L, d, 2*d_in + 2*G*N + H), ``blocks.conv_w`` (L, K, d_in + 2*G*N),
``blocks.conv_b``, ``blocks.a_log`` (L, H), ``blocks.dt_bias`` (L, H),
``blocks.d_skip`` (L, H), ``blocks.gate_norm.scale`` (L, d_in),
``blocks.w_out`` (L, d_in, d), ``final_norm.scale`` (d,).  Imports nothing
of the program.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from perfbench.lib import reftrain as R

TOWER = "blocks"


def dims(conf: dict):
    """(d, d_in, heads, head dim P, groups G, state N, conv width K,
    in-projection width, vocabulary rows: ``vocab_size`` padded up to a
    multiple of ``pad_vocab_size_multiple``)."""
    d = conf["d_model"]
    d_in = conf["expand"] * d
    p = conf["headdim"]
    h = d_in // p
    g, n = conf["ngroups"], conf["d_state"]
    proj = 2 * d_in + 2 * g * n + h
    pad = int(conf.get("pad_vocab_size_multiple", 1))
    rows = -(-int(conf["vocab_size"]) // pad) * pad
    return d, d_in, h, p, g, n, conf["d_conv"], proj, rows


def num_layers(conf: dict) -> int:
    return int(conf["n_layer"])


def _dt_bias(gen, shape, device):
    """The inverse softplus of dt drawn log-uniformly in [1e-3, 1e-1]."""
    u = torch.rand(shape, generator=gen, device=device)
    dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    return dt + torch.log(-torch.expm1(-dt))


def _a_log(gen, shape, device):
    """A = 1..16 spread over the heads, the same in every layer."""
    return torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device)
                     ).expand(shape).contiguous()


def leaf_specs(conf: dict):
    d, d_in, h, p, g, n, k, proj, vocab = dims(conf)
    layers = num_layers(conf)
    conv_ch = d_in + 2 * g * n
    return [
        (("embed", "table"), (vocab, d), R.normal(0.02)),
        (("blocks", "norm", "scale"), (layers, d), R.constant(1.0)),
        (("blocks", "w_in"), (layers, d, proj), R.normal(1 / math.sqrt(d))),
        (("blocks", "conv_w"), (layers, k, conv_ch), R.normal(0.1)),
        (("blocks", "conv_b"), (layers, conv_ch), R.constant(0.0)),
        (("blocks", "a_log"), (layers, h), _a_log),
        (("blocks", "dt_bias"), (layers, h), _dt_bias),
        (("blocks", "d_skip"), (layers, h), R.constant(1.0)),
        (("blocks", "gate_norm", "scale"), (layers, d_in), R.constant(1.0)),
        (("blocks", "w_out"), (layers, d_in, d),
         R.normal(1 / math.sqrt(d_in))),
        (("final_norm", "scale"), (d,), R.constant(1.0)),
    ]


def matmul_params(conf: dict) -> int:
    """Parameters that multiply each token: the projections and the tied
    head (the embedding lookup is not counted)."""
    d, d_in, h, p, g, n, k, proj, vocab = dims(conf)
    return num_layers(conf) * (d * proj + d_in * d) + d * vocab


def scan_shapes(conf: dict, batch: int, seq: int,
                halves: int) -> List[Dict[str, Any]]:
    """One entry a layer's scan call in a step (``halves`` calls a layer
    when CheckFree+ splits the batch): the cost functions' arguments."""
    d, d_in, h, p, g, n, k, proj, vocab = dims(conf)
    b = batch // halves
    return [dict(b=b, t=seq, h=h, p=p, g=g, n=n,
                 chunk=min(conf["chunk_size"], seq))] \
        * (num_layers(conf) * halves)


def program_fields(conf: dict) -> Dict[str, Any]:
    d, d_in, h, p, g, n, k, proj, vocab = dims(conf)
    return {"arch_type": "ssm", "num_layers": num_layers(conf),
            "d_model": d, "vocab_size": vocab,
            "tie_embeddings": bool(conf["tie_embeddings"]),
            "rmsnorm_eps": conf["rms_norm_eps"],
            "ssm": {"state_dim": n, "head_dim": p, "expand": conf["expand"],
                    "conv_width": k, "chunk_size": conf["chunk_size"],
                    "ngroups": g}}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def embed(params, tokens: torch.Tensor, conf: dict) -> torch.Tensor:
    return params["embed"]["table"][tokens.long()]


def embed_backward(grads, tokens: torch.Tensor, g: torch.Tensor,
                   conf: dict) -> None:
    grads["embed"]["table"].index_add_(0, tokens.reshape(-1).long(),
                                       g.reshape(-1, g.shape[-1]))


def ssd(xdt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
        cm: torch.Tensor, ops: R.Ops) -> torch.Tensor:
    """xdt (B, T, H, P) = dt x, a (B, T, H) = dt A, bm/cm (B, T, G, N) ->
    y (B, T, H, P), over the whole sequence at once.  The decays'
    exponents are summed in float64; the masked pairs never reach exp."""
    b, t, h, p = xdt.shape
    g = bm.shape[2]
    cs = torch.cumsum(a.double(), dim=1).transpose(1, 2)          # (B, H, T)
    seg = cs[..., :, None] - cs[..., None, :]                     # (B,H,T,T)
    keep = torch.ones((t, t), dtype=torch.bool, device=a.device).tril()
    decay = torch.exp(seg.masked_fill(~keep, float("-inf"))).float()
    cb = ops.mm(cm.permute(0, 2, 1, 3), bm.permute(0, 2, 3, 1))  # (B,G,T,T)
    cb = cb.repeat_interleave(h // g, dim=1)                      # (B,H,T,T)
    return ops.mm(cb * decay, xdt.transpose(1, 2)).transpose(1, 2)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x (B, T, C), w (K, C), tap K-1 on the
    current token."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + t] * w[i] for i in range(k)) + bias


def block(lp, x: torch.Tensor, conf: dict, ops: R.Ops) -> torch.Tensor:
    """One Mamba2 layer's residual branch."""
    d, d_in, h, p, g, n, k, proj, vocab = dims(conf)
    eps = conf["rms_norm_eps"]
    b, t, _ = x.shape
    zxbcdt = ops.mm(R.rmsnorm(x, lp["norm"]["scale"], eps), lp["w_in"])
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * g * n]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * g * n:]
    xbc = F.silu(causal_conv(xbc, lp["conv_w"], lp["conv_b"]))
    xs = xbc[..., :d_in].reshape(b, t, h, p)
    bm = xbc[..., d_in:d_in + g * n].reshape(b, t, g, n)
    cm = xbc[..., d_in + g * n:].reshape(b, t, g, n)
    dt = F.softplus(dt_raw + lp["dt_bias"])                       # (B, T, H)
    a = dt * -torch.exp(lp["a_log"])
    y = ssd(xs * dt[..., None], a, bm, cm, ops)
    y = (y + xs * lp["d_skip"][:, None]).reshape(b, t, d_in)
    y = R.rmsnorm(y * F.silu(z), lp["gate_norm"]["scale"], eps)
    return ops.mm(y, lp["w_out"])


def loss_tail(params, x: torch.Tensor, labels: torch.Tensor, conf: dict,
              ops: R.Ops) -> torch.Tensor:
    h = R.rmsnorm(x, params["final_norm"]["scale"], conf["rms_norm_eps"])
    return R.cross_entropy(ops.mm(h, params["embed"]["table"].t()), labels)
