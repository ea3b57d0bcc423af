"""mamba2-1.3b [ssm] — 48L d_model=2048 attention-free SSD (state-space
duality), ssm_state=128, vocab=50280.
[arXiv:2405.21060]
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=64, ngroups=1),
    max_seq_len=8192,
    source="arXiv:2405.21060",
)

NUM_STAGES = 8  # 48 layers -> 6 per stage
