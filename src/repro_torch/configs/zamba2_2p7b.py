"""zamba2-2.7b [hybrid] — 54L d_model=2560 (Mamba2 backbone, ssm_state=64)
with shared attention blocks (32H MHA, d_ff=10240) interleaved every 9 SSM
layers; vocab=32000.
[arXiv:2411.15242]

Simplification noted in DESIGN.md: zamba2 alternates two shared blocks and
concatenates the original embedding at each shared block; we use one shared
block with standard residual wiring (the staging/recovery mechanics are
identical).
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    act="gelu_tanh",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=64, ngroups=1),
    attn_every=9,                  # 6 shared-block applications over 54 layers
    max_seq_len=4096,
    source="arXiv:2411.15242",
)

NUM_STAGES = 6  # 54 mamba layers -> 9 per stage (aligned with attn_every)
