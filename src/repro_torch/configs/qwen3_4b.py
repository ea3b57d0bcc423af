"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936;
qk-norm, head_dim=128.
[hf:Qwen/Qwen3-8B]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    arch_type="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    act="silu",
    use_qk_norm=True,
    rmsnorm_eps=1e-6,
    rope_theta=1000000.0,
    max_seq_len=32768,
    source="hf:Qwen/Qwen3-8B",
)

NUM_STAGES = 6  # 36 layers -> 6 per stage
