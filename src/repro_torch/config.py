"""Model configuration for the PyTorch port.

A copy of ``repro.config``'s model configs (``ModelConfig``, ``MoEConfig``,
``SSMConfig``) and training configs (``OptimizerConfig``, ``RecoveryConfig``,
``TrainConfig``), kept here so that the port imports nothing of the JAX
package.  Fields, defaults and derived quantities are unchanged: tests hold
``dataclasses.asdict`` of every registered config, and every default of the
training and serving configs and the input shape suite, equal to the JAX
ones.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
ACTIVATIONS = ("silu", "gelu", "gelu_tanh", "relu")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (token-choice top-k router)."""

    num_experts: int = 0              # routed experts
    top_k: int = 0
    num_shared_experts: int = 0       # deepseek-moe style always-on experts
    d_ff_expert: int = 0              # per-expert FFN hidden size
    router_aux_coef: float = 0.01     # load-balance loss coefficient
    router_jitter: float = 0.0
    capacity_factor: float = 1.25     # GShard capacity factor (dropping)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block configuration."""

    state_dim: int = 0                # N: per-head state size
    head_dim: int = 64                # P: channels per SSD head
    expand: int = 2                   # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 64              # SSD chunk length
    ngroups: int = 1                  # B/C groups


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  ``arch_type`` selects the family module."""

    name: str
    arch_type: str                    # one of ARCH_TYPES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    act: str = "silu"
    use_qk_norm: bool = False
    rmsnorm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: int = 0           # 0 -> full attention; >0 -> SWA width
    swa_every: int = 1                # apply SWA to every k-th layer (1 = all)
    logit_softcap: float = 0.0        # gemma2-style final softcap (0 = off)
    gated_mlp: bool = True            # SwiGLU/GeGLU vs plain 2-layer MLP
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    use_rope: bool = True             # False -> learned absolute positions
    embed_scale: bool = False         # gemma-style sqrt(d) embedding scaling
    # --- MoE ---
    moe: MoEConfig = field(default_factory=MoEConfig)
    moe_every: int = 1                # MoE on every k-th layer (1 = all)
    # --- SSM / hybrid ---
    ssm: SSMConfig = field(default_factory=SSMConfig)
    attn_every: int = 0               # hybrid: shared attn block every k ssm layers
    # --- encoder-decoder (whisper) ---
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0          # frames after conv frontend (stubbed)
    # --- vlm ---
    num_patches: int = 0              # stubbed vision patch embeddings
    # --- misc ---
    max_seq_len: int = 8192
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    source: str = ""                  # citation for the config

    # ---- derived -----------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_decoder_only(self) -> bool:
        return self.arch_type in ("dense", "moe", "ssm", "hybrid", "vlm")

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d

        def attn_params() -> int:
            return d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d

        def mlp_params(ff: int) -> int:
            # gated (SwiGLU/GeGLU): up+gate+down; plain: up+down
            return (3 if self.gated_mlp else 2) * d * ff

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            zx = d * (2 * d_in)                       # in_proj -> z, x
            bc = d * (2 * s.ngroups * s.state_dim)    # B, C projections
            dt = d * nheads                           # dt projection
            conv = s.conv_width * (d_in + 2 * s.ngroups * s.state_dim)
            out = d_in * d
            extra = 2 * nheads                        # A_log, D
            return zx + bc + dt + conv + out + extra

        per_layer = 0
        total = emb + head + d  # + final norm
        if self.arch_type in ("dense", "vlm"):
            per_layer = attn_params() + mlp_params(self.d_ff) + 2 * d
            total += self.num_layers * per_layer
            if self.arch_type == "vlm":
                total += d * d  # projector stub
        elif self.arch_type == "moe":
            m = self.moe
            experts = (m.num_experts + m.num_shared_experts) * 3 * d * m.d_ff_expert
            router = d * m.num_experts
            per_layer = attn_params() + experts + router + 2 * d
            total += self.num_layers * per_layer
        elif self.arch_type == "ssm":
            total += self.num_layers * (ssm_params() + d)
        elif self.arch_type == "hybrid":
            total += self.num_layers * (ssm_params() + d)
            total += attn_params() + mlp_params(self.d_ff) + 2 * d  # shared block
        elif self.arch_type == "encdec":
            enc_layer = attn_params() + mlp_params(self.d_ff) + 2 * d
            dec_layer = 2 * attn_params() + mlp_params(self.d_ff) + 3 * d
            total += self.num_encoder_layers * enc_layer
            total += self.num_layers * dec_layer
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        d = self.d_model
        m = self.moe
        active_experts = (m.top_k + m.num_shared_experts) * 3 * d * m.d_ff_expert
        all_experts = (m.num_experts + m.num_shared_experts) * 3 * d * m.d_ff_expert
        return self.param_count() - self.num_layers * (all_experts - active_experts)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.arch_type in ARCH_TYPES, self.arch_type
        assert self.act in ACTIVATIONS, self.act
        if self.arch_type not in ("ssm",):
            assert self.num_heads >= 1
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
                "num_heads must be a multiple of num_kv_heads")
        if self.arch_type == "moe":
            assert self.moe.num_experts > 0 and self.moe.top_k > 0
        if self.arch_type in ("ssm", "hybrid"):
            assert self.ssm.state_dim > 0
            d_in = self.ssm.expand * self.d_model
            assert d_in % self.ssm.head_dim == 0
        if self.arch_type == "encdec":
            assert self.num_encoder_layers > 0 and self.encoder_seq_len > 0
        if self.arch_type == "vlm":
            assert self.num_patches > 0


# ---------------------------------------------------------------------------
# Training / recovery / serving configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0        # paper: no weight decay
    grad_clip: float = 1.0
    warmup_steps: int = 20
    schedule: str = "cosine"          # cosine | constant | linear
    total_steps: int = 1000
    min_lr_ratio: float = 0.1


@dataclass(frozen=True)
class RecoveryConfig:
    """CheckFree / CheckFree+ configuration (the paper's contribution).

    Field for field the JAX ``RecoveryConfig``.
    """

    strategy: str = "checkfree"       # a name in repro_torch.recovery's registry
    num_stages: int = 4               # transformer stages (excl. embed stage S0)
    lr_boost: float = 1.1             # Alg.1 line 4
    lr_boost_decay: float = 0.995     # per-step decay of the boost back to 1.0
                                      # (1.0 = strictly persistent, as Alg.1)
    lr_boost_cap: float = 2.0         # safety cap under extreme churn
    weighting: str = "grad_norm"      # grad_norm | uniform | copy_prev | random
    swap_fraction: float = 0.5        # CheckFree+ OOO fraction of microbatches
    checkpoint_every: int = 100       # checkpointing baseline frequency (iters)
    checkpoint_dir: str = "/tmp/repro_ckpt"
    failure_rate_per_hour: float = 0.10   # per-stage failure probability / hour
    iteration_time_s: float = 91.3        # paper Table 2 medium-model iteration
    scenario: str = ""                # simulated-cluster environment (not
                                      # ported yet: the trainer refuses it)
    seed: int = 0
    protect_edge_stages: bool = True  # CheckFree (not +) cannot lose S_first/S_last
    # --- statestore (strategy="tiered_ckpt" / "neighbor"): tiered state ---
    store_dir: str = "/tmp/repro_statestore"  # disk/remote tier directories
    hot_every: int = 1                # memory-tier snapshot interval (iters)
    cold_every: int = 0               # disk-tier interval; 0 -> checkpoint_every
    remote_every: int = 0             # remote-tier interval; 0 -> 10x cold
    keep_hot: int = 2                 # snapshots kept per shard in memory
    keep_cold: int = 3                # snapshots kept per shard on disk/remote
    neighbor_cold: bool = True        # neighbor keeps a disk safety net
    # --- adaptive (strategy="adaptive"): Chameleon-style policy switching ---
    adaptive_low: str = "checkfree"   # active while the observed rate is calm
    adaptive_high: str = "checkpoint" # active above the threshold
    adaptive_window: int = 32         # sliding window length (wall iterations)
    adaptive_threshold: float = 0.05  # failures/iteration that trips to high


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 8
    microbatch: int = 2
    seq_len: int = 128
    steps: int = 100
    log_every: int = 10
    eval_every: int = 50
    eval_batches: int = 4
    fuse_window: int = 8      # max iterations fused into one window
                              # (1: one eager step a dispatch)
    seed: int = 0
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)

    @property
    def num_microbatches(self) -> int:
        assert self.global_batch % self.microbatch == 0
        return self.global_batch // self.microbatch


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    prompt_len: int = 32
    max_new_tokens: int = 16
    cache_len: int = 128
    swa_serving_window: int = 0   # >0: force ring-buffer SWA KV cache (long ctx)
    temperature: float = 0.0


# ---------------------------------------------------------------------------
# Input shape suite (the dry-run's)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
