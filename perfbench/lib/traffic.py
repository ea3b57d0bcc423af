"""The benchmark's own traffic: token batches and stage-failure schedules,
both made from ``--seed`` and a traffic mix's parameters.

A traffic mix (``perfbench/traffic/<mix>.json``) fixes the batch, the
sequence length, the token distribution and the churn; this module is the
one generator that reads every mix.  Nothing here imports the program.

Tokens: rows drawn from a Zipf-like unigram distribution over a vocabulary
permuted by the seed (p(rank r) ~ (r + 10)^-1.1), one (B, S+1) block a step,
so every row of every step differs.  Token ids do not change the cost of a
dense or SSM step, so no mix sets the law.  ``tokens`` are the first
S of a row and ``labels`` the last S.

Churn: the failures are a fixed cadence in the wall step, never Bernoulli
draws, so every run of a mix has the same number of failures in the same
places; the seed picks only which stage fails.

* ``cadence``: one failure every ``period`` wall steps, at the steps
  ``k * period + offset`` (k >= 0).
* ``burst``: ``burst`` failures on consecutive wall steps from ``k * period
  + offset``, one a step (so no two stages, adjacent or not, fail on one
  step).

The losable stages are the interior ones (``stages: "interior"``: every
stage but the first and the last, which plain CheckFree cannot rebuild) or
all of them (``"all"``, CheckFree+).  The failing stages follow a seeded
permutation of the losable ones, repeated: every seed gives the same set of
stages, in another order, as far as the run reaches.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number >= 0, more than 32
    bits allowed) and a stream label, independent across labels."""
    return np.random.default_rng([int(seed) % (2 ** 64), *stream])


#: the unigram law's exponent and rank offset
ZIPF_EXPONENT = 1.1
ZIPF_OFFSET = 10.0


def unigram(vocab: int, seed: int) -> np.ndarray:
    """Probabilities of a Zipf-like law p(rank r) ~ (r + ZIPF_OFFSET)^
    -ZIPF_EXPONENT, the ranks assigned to token ids by a permutation drawn
    from ``seed``."""
    ranks = rng_for(seed, 1).permutation(vocab)
    p = (ranks.astype(np.float64) + ZIPF_OFFSET) ** -ZIPF_EXPONENT
    return p / p.sum()


class TokenStream:
    """Step ``i``'s batch {"tokens", "labels"} (int32, (B, S)) for a seed,
    drawn once and kept: a step's rows never change between calls."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.p = unigram(vocab, seed)
        self.cdf = np.cumsum(self.p)
        self.cdf[-1] = 1.0
        self._rng = rng_for(seed, 2)
        self._drawn: List[Dict[str, np.ndarray]] = []

    def _draw(self) -> Dict[str, np.ndarray]:
        u = self._rng.random((self.batch, self.seq + 1))
        raw = np.searchsorted(self.cdf, u, side="right").astype(np.int32)
        np.minimum(raw, self.vocab - 1, out=raw)
        return {"tokens": np.ascontiguousarray(raw[:, :-1]),
                "labels": np.ascontiguousarray(raw[:, 1:])}

    def batch_at(self, i: int) -> Dict[str, np.ndarray]:
        while len(self._drawn) <= i:
            self._drawn.append(self._draw())
        return self._drawn[i]

    def batches(self, start: int, count: int) -> List[Dict[str, np.ndarray]]:
        return [self.batch_at(i) for i in range(start, start + count)]


def losable_stages(num_stages: int, which: str) -> List[int]:
    if which == "interior":
        return list(range(1, num_stages - 1))
    if which == "all":
        return list(range(num_stages))
    raise ValueError(f"losable stages {which!r}: 'interior' or 'all'")


def failure_walls(churn: dict, steps: int) -> List[int]:
    """The wall steps below ``steps`` at which one stage fails."""
    pattern = churn["pattern"]
    period, offset = int(churn["period"]), int(churn.get("offset", 0))
    if pattern == "none":
        return []
    if pattern == "cadence":
        run = 1
    elif pattern == "burst":
        run = int(churn["burst"])
        if run > period:
            raise ValueError("a burst longer than its period")
    else:
        raise ValueError(f"churn pattern {pattern!r}")
    walls = []
    for base in range(offset, steps, period):
        walls.extend(w for w in range(base, base + run) if w < steps)
    return walls


class Schedule:
    """A failure schedule with the trainer's interface, ``.at(wall_step)``
    -> the failing stages (0-based, within the tower)."""

    def __init__(self, by_wall: Dict[int, List[int]]):
        self.by_wall = {int(w): list(s) for w, s in by_wall.items() if s}

    def at(self, step: int) -> List[int]:
        return list(self.by_wall.get(step, ()))

    def __len__(self) -> int:
        return sum(len(s) for s in self.by_wall.values())

    def stages(self) -> List[int]:
        return [s for w in sorted(self.by_wall) for s in self.by_wall[w]]


def churn_schedule(churn: dict, num_stages: int, steps: int,
                   seed: int) -> Schedule:
    """The churn of a mix over ``steps`` wall steps for ``seed``."""
    walls = failure_walls(churn, steps)
    if not walls:
        return Schedule({})
    stages = losable_stages(num_stages, churn["stages"])
    order = rng_for(seed, 3).permutation(stages)
    return Schedule({w: [int(order[i % len(order)])]
                     for i, w in enumerate(walls)})


def check_schedule(failures: Sequence[Sequence], num_stages: int,
                   seed: int) -> Schedule:
    """The failures of the checked steps: ``[[wall, kind], ...]`` with kind
    "interior" (a stage with two neighbours: the merge) or "edge" (the
    first or the last stage: CheckFree+'s copy), the stage drawn from the
    seed within its kind; no stage fails twice."""
    rng = rng_for(seed, 4)
    taken: List[int] = []
    by_wall: Dict[int, List[int]] = {}
    for wall, kind in failures:
        pool = {"interior": losable_stages(num_stages, "interior"),
                "edge": [0, num_stages - 1]}[kind]
        pool = [s for s in pool if s not in taken]
        stage = int(pool[int(rng.integers(len(pool)))])
        taken.append(stage)
        by_wall.setdefault(int(wall), []).append(stage)
    return Schedule(by_wall)


def iterate(stream: TokenStream, start: int,
            count: int) -> Iterator[Dict[str, np.ndarray]]:
    """Batches ``start .. start + count - 1`` of ``stream``, then an error:
    a run that asks for more than its steps is a fault of the harness."""
    for i in range(start, start + count):
        yield stream.batch_at(i)
    raise RuntimeError(f"the trainer asked for more than the {count} "
                       "batches of its run")
