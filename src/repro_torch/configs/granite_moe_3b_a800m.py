"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, MoE 40 routed experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

Note: the assignment line reads "MoE 40e top-8 — 32 experts top-8"; we follow
the structured field (40 experts, top-8) and record the bracket discrepancy.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    act="silu",
    tie_embeddings=True,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=40, top_k=8, num_shared_experts=0,
                  d_ff_expert=512),
    max_seq_len=4096,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

NUM_STAGES = 8  # 32 layers -> 4 per stage
