"""Token sources and the batch stream (numpy only).

A copy of ``SyntheticLM``, ``ByteCorpus`` and ``batch_for`` from
``repro.data.pipeline``: the same seed gives the same token stream in both
packages, so a prompt drawn here is the prompt that ``repro.launch.serve``
would serve.
``make_batches`` is the same infinite batch stream, so both trainers see the
same numpy batches.  :class:`WindowPrefetcher` is a copy of the JAX
package's: the trainer takes batch ``effective_step`` (or the window from
it) by index, so a rollback replays the lost steps' batches, and the next
fused window is stacked on a worker thread while the current one runs.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, Optional, Tuple

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


class ByteCorpus:
    """Byte-level random crops from a text file (vocab 256)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), np.uint8).astype(np.int32)
        if not len(self.data):
            raise ValueError(f"ByteCorpus: {path} is empty")

    def sample(self, rng: np.random.Generator, batch: int, seq: int,
               ) -> np.ndarray:
        n = len(self.data) - seq - 1
        starts = rng.integers(0, max(n, 1), size=batch)
        return np.stack([self.data[s:s + seq + 1] for s in starts])


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


class WindowPrefetcher:
    """Bounded replay cache + background window stacker over a batch stream.

    The trainer draws batch ``step`` (and, on the fused path, the stacked
    window ``[step, step+k)``) by *index* into the deterministic stream;
    rollback recovery replays earlier indices.  This class owns both
    concerns:

    * **bounded replay**: batches older than ``evict_below(step)`` are
      dropped, so long runs hold at most (rollback horizon + lookahead)
      batches instead of every batch ever drawn;
    * **prefetch**: ``prime(step, k)`` schedules the draw + ``np.stack``
      of the next window on a worker thread while the current window runs
      on the device; ``take(step, k)`` collects it (building synchronously
      on a miss, e.g. after an unprimed rollback).

    The underlying iterator is only ever advanced under the lock, by
    whichever thread needs the highest index first, so the stream stays
    deterministic no matter how requests interleave.
    """

    #: windows the worker may have queued at once
    DEPTH = 2

    def __init__(self, batches: Iterable[Dict[str, np.ndarray]]):
        self._it = iter(batches)
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._next = 0                     # next stream index to draw
        self._floor = 0                    # lowest retained index
        self._lock = threading.Lock()
        self._requests: "queue.Queue" = queue.Queue(maxsize=self.DEPTH)
        self._primed: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        self._primed_cv = threading.Condition()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # ---- draw/replay --------------------------------------------------
    def _ensure(self, step: int) -> None:
        """Advance the stream through ``step`` (caller holds the lock)."""
        if step < self._floor:
            raise KeyError(
                f"batch {step} was evicted (floor={self._floor}); the "
                "recovery strategy rolled back deeper than its declared "
                "replay_horizon()")
        while self._next <= step:
            self._cache[self._next] = next(self._it)
            self._next += 1

    def get(self, step: int) -> Dict[str, np.ndarray]:
        """The batch at stream index ``step`` (draws forward on demand)."""
        self._check_error()
        with self._lock:
            self._ensure(step)
            return self._cache[step]

    def stack(self, step: int, k: int) -> Dict[str, np.ndarray]:
        """Window ``[step, step+k)`` stacked on a new leading axis."""
        with self._lock:
            self._ensure(step + k - 1)
            window = [self._cache[s] for s in range(step, step + k)]
        return {key: np.stack([b[key] for b in window]) for key in window[0]}

    def evict_below(self, step: int) -> None:
        """Drop batches with index < ``step`` (the deepest state any
        rollback can reach no longer needs them)."""
        with self._lock:
            if step <= self._floor:
                return
            for s in range(self._floor, min(step, self._next)):
                self._cache.pop(s, None)
            self._floor = step

    @property
    def cached(self) -> int:
        with self._lock:
            return len(self._cache)

    # ---- background stacking ------------------------------------------
    def _worker(self) -> None:
        while True:
            req = self._requests.get()
            try:
                if req is None:
                    return
                step, k = req
                try:
                    stacked = self.stack(step, k)
                except BaseException as e:  # noqa: BLE001 (raised on take)
                    with self._primed_cv:
                        self._error = e
                        self._primed_cv.notify_all()
                    continue
                with self._primed_cv:
                    self._primed[(step, k)] = stacked
                    self._primed_cv.notify_all()
            finally:
                self._requests.task_done()

    def _check_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def prime(self, step: int, k: int) -> None:
        """Schedule ``stack(step, k)`` on the worker thread (drops the
        request instead of blocking when the queue is full)."""
        if self._closed:
            return
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name="batch-prefetch", daemon=True)
            self._thread.start()
        try:
            self._requests.put_nowait((step, k))
        except queue.Full:
            pass

    def take(self, step: int, k: int) -> Dict[str, np.ndarray]:
        """The primed window, or a synchronous build on a miss."""
        with self._primed_cv:
            self._check_error()
            stacked = self._primed.pop((step, k), None)
            if stacked is None and self._requests.unfinished_tasks > 0:
                # a prime may be mid-flight; wait for the queue to drain
                # rather than racing the worker for the iterator
                while (self._requests.unfinished_tasks > 0
                       and (step, k) not in self._primed
                       and self._error is None):
                    self._primed_cv.wait(timeout=0.05)
                self._check_error()
                stacked = self._primed.pop((step, k), None)
            self._primed.clear()        # stale windows (rollback) are dead
        return stacked if stacked is not None else self.stack(step, k)

    def close(self) -> None:
        self._closed = True
        if self._thread is not None and self._thread.is_alive():
            self._requests.put(None)
            self._thread.join(timeout=10.0)
        self._thread = None


def make_batches(cfg: ModelConfig, *, batch: int, seq: int, seed: int = 0,
                 source: Optional[object] = None,
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite deterministic batch stream for ``cfg``."""
    src = source or SyntheticLM(cfg.vocab_size, seed=1234)
    rng = np.random.default_rng(seed)
    while True:
        raw = src.sample(rng, batch, seq)
        yield batch_for(cfg, raw, rng)
