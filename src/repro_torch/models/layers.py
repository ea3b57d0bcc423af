"""Core layers of the dense decoder, in PyTorch.

The counterpart of ``repro.models.layers``: parameters are nested dicts of
tensors with the JAX package's keys and shapes, and each layer is a plain
function on tensors.  Full-sequence attention runs through
``kernels.ops.flash_attention`` (the CUDA kernel on the card) where the JAX
code runs ``_sdpa`` with a causal, sliding-window or no mask, cross-attention
over another sequence's keys included; single-token decode attention stays
plain PyTorch, as the JAX package computes it outside any kernel.
``cross_entropy`` is plain PyTorch with a memory-lean backward, as the JAX
package computes it outside any kernel.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops

Params = Dict[str, Any]
NEG_INF = -1e30


def to_dtype(name) -> torch.dtype:
    """A dtype name of the configs ("bfloat16", "float32", ...) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def cast_tree(tree: Any, dtype) -> Any:
    """Cast every floating leaf to ``dtype`` (the compute-dtype cast)."""
    dt = to_dtype(dtype)
    if isinstance(tree, dict):
        return {k: cast_tree(v, dt) for k, v in tree.items()}
    if torch.is_floating_point(tree):
        return tree.to(dt)
    return tree


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

# applied to each weight as soon as it is drawn, within keep_drawn
_DRAWN: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@contextlib.contextmanager
def keep_drawn(fn: Callable[[torch.Tensor], torch.Tensor]) -> Iterator[None]:
    """Within: every weight the initializers draw goes through ``fn`` as
    soon as it is drawn, before the next draw (a pipeline rank keeps its
    stage's slice of each stacked weight, ``pipeline.spmd.init_shard``).
    The draws themselves do not change."""
    global _DRAWN
    prev, _DRAWN = _DRAWN, fn
    try:
        yield
    finally:
        _DRAWN = prev


# the truncated normal's bounds, in standard deviations, and the bounds of
# the uniform draw that erfinv maps onto them: erf(3 / sqrt(2))
TRUNC_SIGMAS = 3.0
_TRUNC_ERF = math.erf(TRUNC_SIGMAS / math.sqrt(2.0))


def _trunc_normal(gen: torch.Generator, shape, std: float, dtype,
                  device) -> torch.Tensor:
    """A draw of ``shape`` from N(0, std^2) truncated at +-3 std, in
    ``dtype``; on the meta device (the dry-run's shapes, the counterpart of
    ``jax.eval_shape(model.init)``) an empty tensor: nothing is drawn and
    ``gen`` may be None.

    The result is allocated in ``dtype`` and drawn one slice of axis 0 at a
    time when it has a leading layer axis (three or more axes), each slice
    in fp32 by the inverse CDF in place (uniform, ``erfinv``, scale): into
    one buffer of a layer, then cast into its place, or, for an fp32
    result, into its place directly.  The draw holds the result plus one
    layer's fp32, and reads nothing back to the host.
    deepseek-coder-33b's (62, 7168, 19200) MLP leaves are 15.9 GB each in
    bf16; a whole-leaf fp32 draw would add 31.8 GB beside them.
    """
    t = torch.empty(shape, dtype=to_dtype(dtype), device=device)
    if not t.is_meta:
        pieces = t if t.dim() >= 3 else t[None]
        # an fp32 result is drawn in place; the same draws either way
        buf = None if t.dtype == torch.float32 else torch.empty(
            pieces.shape[1:], dtype=torch.float32, device=device)
        for piece in pieces:
            x = piece if buf is None else buf
            x.uniform_(-_TRUNC_ERF, _TRUNC_ERF, generator=gen)
            x.erfinv_().mul_(math.sqrt(2.0))
            x.clamp_(-TRUNC_SIGMAS, TRUNC_SIGMAS).mul_(std)
            if buf is not None:
                piece.copy_(buf)
        del buf
    return t if _DRAWN is None else _DRAWN(t)


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               device) -> torch.Tensor:
    """Truncated normal at +-3 sigma, std 1/sqrt(fan_in) (LLaMa-style).

    ``shape`` is (fan_in, fan_out), or (L, fan_in, fan_out) for weights
    stacked over layers.  The draws differ from JAX's for the same seed:
    tests load JAX parameters through ``repro_torch.convert`` instead.
    """
    return _trunc_normal(gen, shape, 1.0 / math.sqrt(shape[-2]), dtype, device)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               device) -> torch.Tensor:
    return _trunc_normal(gen, shape, 0.02, dtype, device)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def init_rmsnorm(shape, dtype, device) -> Params:
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def init_layernorm(shape, dtype, device) -> Params:
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(p, x, cfg.rmsnorm_eps)
    return rmsnorm(p, x, cfg.rmsnorm_eps)


def init_norm_cfg(shape, dtype, device, cfg: ModelConfig) -> Params:
    if cfg.norm == "layernorm":
        return init_layernorm(shape, dtype, device)
    return init_rmsnorm(shape, dtype, device)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """theta^(-2i / head_dim), i < head_dim / 2, in fp32: reckoned in
    float64 and rounded once, so that every device holds the same
    frequencies.  An fp32 quotient and power are off by up to ~14 ulps, and
    each device's ``pow`` is off differently; at positions near 2^19 one
    ulp of a frequency moves the angle by ~0.03 rad times the frequency."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
    return (1.0 / (theta ** (exps / head_dim))).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  Split-half rotation, fp32 angles."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    angles = positions.float()[..., None] * freqs               # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA / MQA, optional qk-norm, optional sliding window)
# ---------------------------------------------------------------------------

def _lead(layers: Optional[int]) -> Tuple[int, ...]:
    return () if layers is None else (layers,)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                   layers: Optional[int]) -> Params:
    """Attention weights of ``layers`` blocks stacked on axis 0, or of one
    block with no layer axis when ``layers`` is None."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    n = _lead(layers)
    p: Params = {
        "wq": dense_init(gen, (*n, d, nq * hd), dtype, device),
        "wk": dense_init(gen, (*n, d, nkv * hd), dtype, device),
        "wv": dense_init(gen, (*n, d, nkv * hd), dtype, device),
        "wo": dense_init(gen, (*n, nq * hd, d), dtype, device),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = init_rmsnorm((*n, hd), dtype, device)
        p["k_norm"] = init_rmsnorm((*n, hd), dtype, device)
    return p


def _qkv(p: Params, x: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig, *, use_rope: bool = True,
         kv: Optional[torch.Tensor] = None):
    """q from ``x``; k, v from ``kv`` (another sequence: cross-attention,
    no rope) or from ``x``.  Rope is the caller's choice, as in the JAX
    layer: every decoder-only family passes ``use_rope=True`` whatever
    cfg.use_rope says (use_rope=False there only adds the learned
    pos_embed); the encoder-decoder family passes False."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    src = x if kv is None else kv
    t = src.shape[1]
    q = (x @ p["wq"]).view(b, s, cfg.num_heads, hd)
    k = (src @ p["wk"]).view(b, t, cfg.num_kv_heads, hd)
    v = (src @ p["wv"]).view(b, t, cfg.num_kv_heads, hd)
    if cfg.use_qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.rmsnorm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.rmsnorm_eps)
    if use_rope and kv is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p: Params, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, causal: bool = True, window: int = 0,
              kv: Optional[torch.Tensor] = None, use_rope: bool = True,
              return_kv: bool = False):
    """Full-sequence attention (forward / prefill).

    ``causal``: each query sees the keys up to its own position (False: the
    encoder's bidirectional attention).  ``window`` > 0 limits each query to
    the last ``window`` keys (SWA).  ``kv``: (B, T, d) states of another
    sequence (the encoder's), the source of k and v: cross-attention, full
    and without rope.  ``return_kv``: also return the (k, v) tensors
    (prefill cache building).
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg, use_rope=use_rope, kv=kv)
    if kv is not None:
        causal, window = False, 0
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(b, s, -1) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def _sdpa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B, S, nq, D); k/v: (B, T, nkv, D); mask (B, S, T), True = attend.

    GQA by head grouping, fp32 logits from the cache, fp32 softmax.
    """
    b, s, nq, d = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, nq, d).to(q.dtype)


def attention_decode(p: Params, x: torch.Tensor, pos: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cfg: ModelConfig, *, window: int = 0,
                     use_rope: bool = True,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a KV cache.

    x: (B, 1, d); pos: (B,) absolute position of the new token.
    cache_k/v: (B, C, nkv, hd), a ring buffer of capacity C == window when
    ``window`` > 0.  The new k/v are written into the cache IN PLACE at slot
    ``pos`` (``pos % C`` for a ring); the JAX code blends a one-hot row in,
    ``cache * (1 - oh) + oh * k``, which gives the same values for finite
    caches.  ``use_rope=False``: no rotation (the encoder-decoder family's
    decoder).  Returns (out, cache_k, cache_v).
    """
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    cap = cache_k.shape[1]
    q, k, v = _qkv(p, x, pos[:, None], cfg, use_rope=use_rope)

    slot = pos % cap if window > 0 else pos
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k[:, 0]
    cache_v[rows, slot] = v[:, 0]

    kpos = torch.arange(cap, device=x.device)[None, :]          # slot index
    if window > 0:
        # ring buffer: valid slots hold absolute positions in (pos-window, pos]
        p_ = pos[:, None]
        abs_base = torch.div(p_, cap, rounding_mode="floor") * cap
        abs_pos = torch.where(kpos <= p_ % cap, abs_base + kpos,
                              abs_base - cap + kpos)
        valid = (abs_pos >= 0) & (abs_pos > p_ - window) & (abs_pos <= p_)
    else:
        valid = kpos <= pos[:, None]
    out = _sdpa_decode(q, cache_k, cache_v, valid[:, None, :],
                       1.0 / math.sqrt(hd))
    return out.reshape(b, 1, -1) @ p["wo"], cache_k, cache_v


def cross_attention_decode(p: Params, x: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One decoder token against the cached cross K/V: x (B, 1, d); ck/cv
    (B, F, nkv, hd), computed once at prefill.  Every key is visible and
    there is no rope (``repro/models/encdec.py`` ``decode_step``)."""
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    q = (x @ p["wq"]).view(b, 1, cfg.num_heads, hd)
    mask = torch.ones((b, 1, ck.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa_decode(q, ck, cv, mask, 1.0 / math.sqrt(hd))
    return out.reshape(b, 1, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# MLPs (SwiGLU / GeGLU and plain)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, dtype, device,
             layers: Optional[int]) -> Params:
    """Gated MLP weights of width ``ff``, stacked on axis 0 as
    ``init_attention``'s (also the MoE layer's shared experts)."""
    n = _lead(layers)
    return {"w_gate": dense_init(gen, (*n, d, ff), dtype, device),
            "w_up": dense_init(gen, (*n, d, ff), dtype, device),
            "w_down": dense_init(gen, (*n, ff, d), dtype, device)}


def init_mlp_cfg(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                 layers: Optional[int]) -> Params:
    """The config's MLP weights (``cfg.d_ff`` wide), gated or plain."""
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.gated_mlp:
        return init_mlp(gen, d, ff, dtype, device, layers)
    n = _lead(layers)
    return {"w_up": dense_init(gen, (*n, d, ff), dtype, device),
            "w_down": dense_init(gen, (*n, ff, d), dtype, device)}


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x)
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    return (_act(act, x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def mlp_plain(p: Params, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    return _act(act, x @ p["w_up"]) @ p["w_down"]


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.gated_mlp:
        return mlp(p, x, cfg.act)
    return mlp_plain(p, x, cfg.act)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed(p: Params, tokens: torch.Tensor, scale: bool = False) -> torch.Tensor:
    x = p["table"][tokens]
    if scale:  # gemma-style sqrt(d) embedding scale, rounded to x's dtype
        # a 0-d CPU tensor: a kernel argument on the card, no copy to the
        # device (which a CUDA graph could not capture)
        x = x * torch.tensor(math.sqrt(x.shape[-1]), dtype=x.dtype)
    return x


def unembed(p: Params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = x @ p["table"].T
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def unembed_w(p: Params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = x @ p["w"]
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

class _TokenNLL(torch.autograd.Function):
    """Per-token NLL with a memory-lean backward (``_token_nll`` of
    ``repro/models/layers.py``).

    Autograd of a fp32 logsumexp would save an fp32 (B, S, V) softmax.  This
    keeps the logits in their compute dtype and recomputes the softmax in
    the backward, with ``p`` cast to the logits' dtype before the gradient
    is formed in that dtype.
    """

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor):
        idx = labels.long()[..., None]
        logz = torch.logsumexp(logits.float(), dim=-1)
        gold = logits.gather(-1, idx)[..., 0]
        ctx.save_for_backward(logits, idx, logz)
        return logz - gold.float()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, idx, logz = ctx.saved_tensors
        p = torch.exp(logits.float() - logz[..., None]).to(logits.dtype)
        # p - onehot(labels), without building the one-hot: subtracting 1 at
        # the label rounds as the dense subtraction does
        p.scatter_add_(-1, idx, torch.full(idx.shape, -1.0, dtype=p.dtype,
                                           device=p.device))
        return p * g[..., None].to(logits.dtype), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy (fp32 accumulation). labels: int (B, S)."""
    nll = _TokenNLL.apply(logits, labels)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
