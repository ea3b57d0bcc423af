"""internvl2-76b [vlm] — LLM backbone 80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256 (llama-3-70b family) consuming stubbed InternViT
patch embeddings through an MLP projector.
[arXiv:2404.16821]

The vision tower is a STUB per the assignment: ``input_specs`` provides
(B, 256, 1024) patch embeddings; the projector maps them into the residual
stream and is replicated (CheckFree+ embedding path).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    act="silu",
    rope_theta=500000.0,
    num_patches=256,
    max_seq_len=8192,
    source="arXiv:2404.16821",
)

NUM_STAGES = 8  # 80 layers -> 10 per stage
