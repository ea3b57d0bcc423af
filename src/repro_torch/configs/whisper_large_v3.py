"""whisper-large-v3 [audio] — enc-dec, 32 encoder + 32 decoder layers,
d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866; conv frontend STUBBED
(inputs are (B, 1500, 1280) frame embeddings).
[arXiv:2212.04356]

Whisper idioms: layernorm, plain (non-gated) GELU MLP, learned absolute
positions, tied deembedding.  ``long_500k`` is SKIPPED for this arch — the
decoder is capped at 448 target positions by construction (see DESIGN.md §6).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="encdec",
    num_layers=32,                 # decoder layers
    num_encoder_layers=32,
    encoder_seq_len=1500,          # 30 s of audio after the (stubbed) conv
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    act="gelu",
    gated_mlp=False,
    norm="layernorm",
    use_rope=False,
    tie_embeddings=True,
    max_seq_len=4096,              # mechanically extended for train_4k lowering
    source="arXiv:2212.04356",
)

NUM_STAGES = 8  # 32 decoder layers -> 4 per stage (encoder staged separately)
