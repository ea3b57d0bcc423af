"""Retention / GC policies for the state store (the counterpart of
``repro.statestore.policy``).

A policy bounds how many snapshots of each shard a tier keeps.  The hot
memory tier typically keeps 2 (the double buffer: current + previous);
colder tiers keep a small history so a corrupted newest checkpoint still
leaves something to roll back to.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.statestore.tiers import StorageTier

DEFAULT_KEEP = 3


@dataclass(frozen=True)
class RetentionPolicy:
    """``keep[tier_name]`` = newest snapshots retained per shard on that
    tier (missing names fall back to ``default_keep``; 0 = keep all)."""

    keep: Dict[str, int] = field(default_factory=dict)
    default_keep: int = DEFAULT_KEEP

    def keep_for(self, tier_name: str) -> int:
        return self.keep.get(tier_name, self.default_keep)

    def apply(self, tier: StorageTier, shard_id: str) -> int:
        """Delete the oldest snapshots of ``shard_id`` beyond the tier's
        budget; returns the number deleted."""
        budget = self.keep_for(tier.name)
        if budget <= 0:
            return 0
        steps = tier.steps(shard_id)
        doomed = steps[:-budget] if len(steps) > budget else []
        for s in doomed:
            tier.delete(shard_id, s)
        return len(doomed)
