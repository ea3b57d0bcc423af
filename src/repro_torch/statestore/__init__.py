"""Tiered, asynchronous state management (TierCheck / FFTrainer-style).

The counterpart of ``repro.statestore``: a tiered state store (peer memory
-> local disk -> remote storage, each with capacity/latency/bandwidth),
asynchronous double-buffered snapshots, sharded per-stage checkpoints,
retention policies, and a codec that writes the JAX package's file format
(bf16 included, bit-exactly).  Two recovery strategies ride on it:
``tiered_ckpt`` and ``neighbor``.

    from repro_torch.statestore import StateStore, MemoryTier, DiskTier

    store = StateStore([MemoryTier(specs["mem"]),
                        DiskTier(specs["disk"], "/tmp/ckpt")])
    store.put(params, step=10, shard_id="stage01", tier="mem", host=2)
    result = store.restore("stage01", template=params)
"""
from repro_torch.statestore.codec import (CodecError, Snapshot,  # noqa: F401
                                          copy_into, decode, encode,
                                          host_snapshot, snapshot_to_tree,
                                          tree_nbytes)
from repro_torch.statestore.policy import RetentionPolicy  # noqa: F401
from repro_torch.statestore.snapshot import (AsyncSnapshotter,  # noqa: F401
                                             SnapshotWriteError)
from repro_torch.statestore.store import (RestoreResult,  # noqa: F401
                                          StateStore, StoreError)
from repro_torch.statestore.tiers import (DiskTier, MemoryTier,  # noqa: F401
                                          RemoteTier, RetryPolicy,
                                          StorageTier, TierError)

# import for registration side effects: tiered_ckpt / neighbor strategies
from repro_torch.statestore import strategies as _strategies  # noqa: F401,E402
