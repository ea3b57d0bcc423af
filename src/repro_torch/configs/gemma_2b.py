"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000;
GeGLU activation, head_dim=256, sqrt(d)-scaled tied embeddings.
[arXiv:2403.08295]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu_tanh",               # GeGLU
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
    max_seq_len=8192,
    source="arXiv:2403.08295",
)

NUM_STAGES = 6  # 18 layers -> 3 per stage
