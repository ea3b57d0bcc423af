"""Synthetic token source for serving (numpy only).

A copy of ``SyntheticLM`` and ``batch_for`` from ``repro.data.pipeline``: the
same seed gives the same token stream in both packages, so a prompt drawn
here is the prompt that ``repro.launch.serve`` would serve.
``make_batches`` is the same infinite batch stream, so both trainers see the
same numpy batches.  :class:`ReplayCache` is the replay half of the JAX
package's ``WindowPrefetcher``: the trainer takes batch ``effective_step``
by index, so a rollback replays the lost steps' batches.  Stacking fused
windows on a background thread waits for fused windows (ROADMAP.md queue 1,
item 3).
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

import numpy as np

from repro_torch.config import ModelConfig

# stubbed vision patch width of the vlm family (``repro.models.vlm.D_PATCH``)
D_PATCH = 1024


class SyntheticLM:
    """Sparse Markov chain with templated segments.

    Each token has ``branch`` plausible successors with a peaked distribution;
    every ``period`` tokens the chain resets to a "sentence start" state drawn
    from a small set.  Conditional entropy ~= H(branch distribution).
    """

    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 8,
                 period: int = 64):
        self.vocab = vocab_size
        self.branch = min(branch, vocab_size)
        self.period = period
        rng = np.random.default_rng(seed)
        # successor table: (V, branch) token ids + fixed peaked probs
        self.succ = rng.integers(0, vocab_size, size=(vocab_size, self.branch))
        p = np.arange(1, self.branch + 1, dtype=np.float64)[::-1] ** 2.0
        self.probs = p / p.sum()
        self.starts = rng.integers(0, vocab_size, size=16)

    def sample(self, rng: np.random.Generator, batch: int, seq: int,
               ) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int32)
        cur = self.starts[rng.integers(0, len(self.starts), size=batch)]
        for t in range(seq + 1):
            reset = (t % self.period) == 0
            if reset and t > 0:
                cur = self.starts[rng.integers(0, len(self.starts),
                                               size=batch)]
            out[:, t] = cur
            choice = rng.choice(self.branch, size=batch, p=self.probs)
            cur = self.succ[cur, choice]
        return out


def batch_for(cfg: ModelConfig, raw: np.ndarray,
              rng: Optional[np.random.Generator] = None,
              ) -> Dict[str, np.ndarray]:
    """raw: (B, S+1) token stream -> model batch dict (adds stub modalities)."""
    batch = {"tokens": raw[:, :-1].astype(np.int32),
             "labels": raw[:, 1:].astype(np.int32)}
    b, s = batch["tokens"].shape
    rng = rng or np.random.default_rng(0)
    if cfg.arch_type == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, D_PATCH)).astype(np.float32)
    return batch


class ReplayCache:
    """Bounded replay cache over a deterministic batch stream.

    :meth:`get` returns the batch at stream index ``step``, drawing the
    stream forward on demand; rollback recovery asks for earlier indices
    again.  :meth:`evict_below` drops the batches no rollback can reach any
    more, so a long run holds at most (rollback horizon + 1) batches.
    """

    def __init__(self, batches: Iterable[Dict[str, np.ndarray]]):
        self._it = iter(batches)
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._next = 0                     # next stream index to draw
        self._floor = 0                    # lowest retained index

    def get(self, step: int) -> Dict[str, np.ndarray]:
        """The batch at stream index ``step``."""
        if step < self._floor:
            raise KeyError(
                f"batch {step} was evicted (floor={self._floor}); the "
                "recovery strategy rolled back deeper than its declared "
                "replay_horizon()")
        while self._next <= step:
            self._cache[self._next] = next(self._it)
            self._next += 1
        return self._cache[step]

    def evict_below(self, step: int) -> None:
        """Drop batches with index < ``step``."""
        if step <= self._floor:
            return
        for s in range(self._floor, min(step, self._next)):
            self._cache.pop(s, None)
        self._floor = step

    @property
    def cached(self) -> int:
        return len(self._cache)


def make_batches(cfg: ModelConfig, *, batch: int, seq: int, seed: int = 0,
                 source: Optional[object] = None,
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite deterministic batch stream for ``cfg``."""
    src = source or SyntheticLM(cfg.vocab_size, seed=1234)
    rng = np.random.default_rng(seed)
    while True:
        raw = src.sample(rng, batch, seq)
        yield batch_for(cfg, raw, rng)
