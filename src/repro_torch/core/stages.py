"""Stage partitioning: maps a model's stacked parameter tree onto the paper's
pipeline stages.

The counterpart of ``repro.core.stages``.  Stage ``S0`` (outside the index
space here) holds the embedding and de-embedding; transformer stages
``S1..SK`` each hold consecutive blocks of the tower.  Blocks are stacked on
axis 0, so a stage is a contiguous slice of every leaf of the tower subtree:
:meth:`StagePartition.get_stage` returns views of those slices and
:meth:`StagePartition.set_stage` copies into them in place, where the JAX code
builds a new tree with ``dynamic_update_slice``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as TR
from repro_torch.config import ModelConfig

Params = Dict[str, Any]


def balanced_layer_counts(num_layers: int, num_stages: int) -> Tuple[int, ...]:
    """Most-even contiguous split of ``num_layers`` over ``num_stages``: the
    first ``num_layers % num_stages`` stages take one extra layer."""
    assert 1 <= num_stages <= num_layers, (num_layers, num_stages)
    base, extra = divmod(num_layers, num_stages)
    return tuple(base + (1 if i < extra else 0) for i in range(num_stages))


def towers(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """The staged residual towers of each family: (param key, num layers)."""
    if cfg.arch_type in ("dense", "moe", "vlm"):
        return [("blocks", cfg.num_layers)]
    if cfg.arch_type in ("ssm", "hybrid"):
        return [("mamba" if cfg.arch_type == "hybrid" else "blocks",
                 cfg.num_layers)]
    if cfg.arch_type == "encdec":
        return [("enc_blocks", cfg.num_encoder_layers),
                ("dec_blocks", cfg.num_layers)]
    raise ValueError(cfg.arch_type)


class StagePartition:
    """Contiguous partition of the primary tower into ``num_stages`` stages.

    The default layout is balanced; ``layer_counts`` gives each stage its own
    number of consecutive blocks (the variable layouts of elastic
    repartitioning).
    """

    def __init__(self, cfg: ModelConfig, num_stages: int, tower: int = 0,
                 layer_counts: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.tower_key, self.num_layers = towers(cfg)[tower]
        self.num_stages = num_stages
        if layer_counts is None:
            layer_counts = balanced_layer_counts(self.num_layers, num_stages)
        self.layer_counts = tuple(int(c) for c in layer_counts)
        assert len(self.layer_counts) == num_stages, (
            f"{len(self.layer_counts)} counts for {num_stages} stages")
        assert all(c >= 1 for c in self.layer_counts), self.layer_counts
        assert sum(self.layer_counts) == self.num_layers, (
            f"{self.layer_counts} does not cover {self.num_layers} layers")
        offsets = [0]
        for c in self.layer_counts:
            offsets.append(offsets[-1] + c)
        self._offsets = tuple(offsets)
        self.uniform = len(set(self.layer_counts)) == 1
        #: layers per stage for the uniform layout, None when variable
        self.layers_per_stage = self.layer_counts[0] if self.uniform else None

    # ---- slicing -----------------------------------------------------
    def stage_bounds(self, i: int) -> Tuple[int, int]:
        assert 0 <= i < self.num_stages
        return self._offsets[i], self._offsets[i + 1]

    def stage_of_layer(self, layer: int) -> int:
        """The stage whose contiguous range holds ``layer``."""
        assert 0 <= layer < self.num_layers
        for i in range(self.num_stages):
            if layer < self._offsets[i + 1]:
                return i
        raise AssertionError(layer)

    def get_stage(self, params: Params, i: int) -> Params:
        """Views of stage ``i``'s slice of every tower leaf."""
        lo, hi = self.stage_bounds(i)
        return TR.map(lambda a: a[lo:hi], params[self.tower_key])

    @torch.no_grad()
    def set_stage(self, params: Params, i: int, stage: Params) -> Params:
        """Copy ``stage`` into stage ``i``'s slice of the tower, in place
        (cast to each leaf's dtype); returns ``params``."""
        lo, hi = self.stage_bounds(i)
        TR.map(lambda a, s: a[lo:hi].copy_(s), params[self.tower_key], stage)
        return params

    # ---- per-stage gradient norms (Alg. 1's omega) ---------------------
    def stage_grad_sqnorms(self, grads: Params) -> torch.Tensor:
        """omega_i = ||grad W_{s,i}||^2, a (num_stages,) fp32 tensor.

        Per-layer squared norms of the stacked tower, then a segment sum
        into stages, on the device.  The plain version: training takes the
        per-layer sums from ``ops.adam_sumsq``'s pass over the gradients and
        reduces them with :meth:`stage_sums`.
        """
        per_layer = None
        for leaf in TR.leaves(grads[self.tower_key]):
            sq = leaf.float().square().reshape(leaf.shape[0], -1).sum(1)
            per_layer = sq if per_layer is None else per_layer + sq
        return self.stage_sums(per_layer)

    def stage_sums(self, per_layer: torch.Tensor) -> torch.Tensor:
        """The (num_layers,) per-layer sums segment-summed into stages."""
        if self.uniform:
            # the JAX code's reduction shape on the uniform layout
            return per_layer.reshape(self.num_stages,
                                     self.layers_per_stage).sum(1)
        return torch.stack([per_layer[lo:hi].sum() for lo, hi in
                            zip(self._offsets[:-1], self._offsets[1:])])

    def tower_flags(self, params: Params) -> List[bool]:
        """For each leaf of ``params`` in ``tree.leaves`` order: whether it
        is a leaf of the stacked tower (one row a layer along axis 0)."""
        return [path[0] == self.tower_key
                for path, _ in TR.leaves_with_path(params)]

    # ---- replicated (stage-0) leaves ----------------------------------
    def stage0_keys(self, params: Params) -> List[str]:
        """Keys that belong to the embedding stage / replication path."""
        return [k for k in params.keys() if k not in
                {key for key, _ in towers(self.cfg)}]


# ---------------------------------------------------------------------------
# elastic re-layout helpers
# ---------------------------------------------------------------------------

def remap_stage_stats(old: StagePartition, new: StagePartition,
                      values: Any) -> Any:
    """Re-bucket per-stage statistics (omegas) from ``old`` to ``new``.

    Each old stage's value is spread uniformly over its layers, then the
    per-layer values are re-summed under the new bounds.  Returns None when
    ``values`` is None.
    """
    if values is None:
        return None
    assert old.num_layers == new.num_layers, (old.num_layers, new.num_layers)
    vals = torch.as_tensor(values, dtype=torch.float32)
    per_layer = torch.cat([(vals[i] / c).reshape(1).expand(c)
                           for i, c in enumerate(old.layer_counts)])
    return torch.stack([per_layer[lo:hi].sum()
                        for lo, hi in zip(new._offsets[:-1], new._offsets[1:])])


def moved_layers(old: StagePartition, old_slots: Sequence[int],
                 new: StagePartition, new_slots: Sequence[int]) -> int:
    """How many layers change owning node between two layouts.

    ``old_slots`` / ``new_slots`` map partition stage index -> cluster slot.
    """
    assert old.num_layers == new.num_layers
    assert len(old_slots) == old.num_stages
    assert len(new_slots) == new.num_stages
    n = 0
    for layer in range(old.num_layers):
        a = old_slots[old.stage_of_layer(layer)]
        b = new_slots[new.stage_of_layer(layer)]
        n += a != b
    return n
