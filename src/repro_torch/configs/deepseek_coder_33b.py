"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256; llama architecture.
[arXiv:2401.14196]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    act="silu",
    rope_theta=100000.0,
    max_seq_len=16384,
    source="arXiv:2401.14196",
)

NUM_STAGES = 31  # 62 layers -> 2 per stage (62 = 2 x 31)
