"""Out-of-order pipeline schedule for CheckFree+ (paper §4.3).

For half the microbatches the stages run in order ``S1,S2,...,SK``; for the
other half the first two and last two transformer stages are swapped:
``S2,S1,...,SK,SK-1``.  S2 thereby learns S1's role (and S_{K-1} learns
S_K's) "for free" — no redundant compute, the swap is just a different
composition order.

With blocks stacked on axis 0, a swapped stage order is a permutation of
layer indices.  A copy of ``repro.core.swap`` (numpy only): the port's
forward walks the tower in this order (``transformer.forward(order=...)``)
where the JAX code gathers a permuted copy of the tower.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def stage_permutations(num_stages: int) -> Tuple[List[int], List[int]]:
    """(normal, swapped) stage orders, 0-based transformer stages."""
    normal = list(range(num_stages))
    if num_stages < 4:
        return normal, normal  # nothing meaningful to swap
    swapped = normal.copy()
    swapped[0], swapped[1] = swapped[1], swapped[0]
    swapped[-1], swapped[-2] = swapped[-2], swapped[-1]
    return normal, swapped


def swap_permutation(num_layers: int, num_stages: int,
                     bounds: Optional[Sequence[Tuple[int, int]]] = None
                     ) -> np.ndarray:
    """Layer-index permutation realizing the swapped stage order.

    ``bounds`` gives each stage's (lo, hi) layer range for variable
    (elastic) layouts; when omitted the layout is the seed equal split.
    """
    if bounds is None:
        assert num_layers % num_stages == 0
        lps = num_layers // num_stages
        bounds = [(s * lps, (s + 1) * lps) for s in range(num_stages)]
    assert len(bounds) == num_stages
    _, swapped = stage_permutations(num_stages)
    idx = []
    for s in swapped:
        idx.extend(range(bounds[s][0], bounds[s][1]))
    assert len(idx) == num_layers, (len(idx), num_layers)
    return np.asarray(idx, np.int32)
