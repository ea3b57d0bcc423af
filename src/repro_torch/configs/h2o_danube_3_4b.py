"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    act="silu",
    sliding_window=4096,          # mistral-style SWA (native long_500k support)
    rope_theta=10000.0,
    max_seq_len=8192,
    source="arXiv:2401.16818",
)

NUM_STAGES = 6  # 24 layers -> 4 per stage
