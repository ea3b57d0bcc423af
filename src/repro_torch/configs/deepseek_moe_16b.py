"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff=1408/expert
vocab=102400; 2 shared + 64 routed experts top-6, fine-grained.
[arXiv:2401.06066]
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=102400,
    act="silu",
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  d_ff_expert=1408),
    max_seq_len=4096,
    source="arXiv:2401.06066",
)

NUM_STAGES = 7  # 28 layers -> 4 per stage
