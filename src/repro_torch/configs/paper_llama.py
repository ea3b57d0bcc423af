"""The paper's own LLaMa models (Table 4): small 124M / medium 500M /
large 1.5B, trained with Adam (0.9, 0.999), no weight decay.
"""
from repro_torch.config import ModelConfig

SMALL = ModelConfig(
    name="paper-llama-124m",
    arch_type="dense",
    num_layers=12, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=1376, vocab_size=32000, act="silu", max_seq_len=512,
    source="paper Table 4 (small)",
)
SMALL_STAGES = 4   # paper: 4 stages for the small model (3 layers each)

MEDIUM = ModelConfig(
    name="paper-llama-500m",
    arch_type="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2752, vocab_size=32000, act="silu", max_seq_len=1024,
    source="paper Table 4 (medium)",
)
MEDIUM_STAGES = 6  # paper §5.1: six transformer stages of 4 layers

LARGE = ModelConfig(
    name="paper-llama-1.5b",
    arch_type="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=5504, vocab_size=32000, act="silu", max_seq_len=4096,
    source="paper Table 4 (large)",
)
LARGE_STAGES = 6
