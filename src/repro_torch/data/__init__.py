"""Token sources and the batch stream for the port (numpy only)."""
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLM, ByteCorpus, make_batches, batch_for)
