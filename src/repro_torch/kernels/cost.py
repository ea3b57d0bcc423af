"""Operation and byte counts of the hand-written kernels, in one place.

Two readers: ``chip_smoke.py``, whose bounds divide these counts by the
card's rates, and the meta branches of the kernels (``kernels.ops``), which
credit them to the dry-run's :func:`tally` where no kernel runs.  Each
function returns ``(bytes, flops)`` of one call: the bytes the kernel must
move (each input read once, each output written once) and the operations it
does on this call's inputs (a mask's pairs only, not the full product).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

Cost = Tuple[int, int]


def visible_pairs(s: int, causal: bool, window: int,
                  sk: Optional[int] = None) -> int:
    """The (query, key) pairs a mask lets through: ``s`` queries over ``sk``
    keys (default ``s``); query q sees key j where j <= q (causal) and
    j > q - window (window > 0).  Exact, one range of keys a query."""
    sk = s if sk is None else sk
    q = np.arange(s, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(s, sk - 1, np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_fwd(b: int, hq: int, hkv: int, s: int, sk: int, d: int, *,
              itemsize: int, causal: bool, window: int) -> Cost:
    """q, k, v read once; out (like q) and the fp32 lse written once; QK^T
    and PV over the visible pairs."""
    q_bytes = b * hq * s * d * itemsize
    kv_bytes = b * hkv * sk * d * itemsize
    nbytes = 2 * q_bytes + 2 * kv_bytes + b * hq * s * 4
    return nbytes, 4 * b * hq * d * visible_pairs(s, causal, window, sk)


def flash_bwd_dq(b: int, hq: int, hkv: int, s: int, sk: int, d: int, *,
                 itemsize: int, causal: bool, window: int) -> Cost:
    """q, k, v, dO, lse and delta read once, dq written once; QK^T, dO V^T
    and dS K over the visible pairs."""
    q_bytes = b * hq * s * d * itemsize
    k_bytes = b * hkv * sk * d * itemsize
    nbytes = 3 * q_bytes + 2 * k_bytes + 2 * b * hq * s * 4
    pairs = b * hq * visible_pairs(s, causal, window, sk)
    return nbytes, 2 * 3 * d * pairs


def flash_bwd_dkv(b: int, hq: int, hkv: int, s: int, sk: int, d: int, *,
                  itemsize: int, causal: bool, window: int) -> Cost:
    """The same inputs read once, dk and dv written once; QK^T, dO V^T,
    P^T dO and dS^T Q over the visible pairs."""
    q_bytes = b * hq * s * d * itemsize
    k_bytes = b * hkv * sk * d * itemsize
    nbytes = 2 * q_bytes + 4 * k_bytes + 2 * b * hq * s * 4
    pairs = b * hq * visible_pairs(s, causal, window, sk)
    return nbytes, 2 * 4 * d * pairs


def stage_merge(numel: int, itemsize: int = 4) -> Cost:
    """x and y read, out written; ca * x + cb * y an element."""
    return 3 * numel * itemsize, 3 * numel


def adam_sumsq(numel: int) -> Cost:
    """Every fp32 gradient element read once; a multiply and an add each."""
    return 4 * numel, 2 * numel


def adam_update(numel: int) -> Cost:
    """p, g, m, v read and p, m, v written (fp32); 15 operations an
    element."""
    return 28 * numel, 15 * numel


def ssd_fwd(b: int, t: int, h: int, p: int, g: int, n: int, chunk: int, *,
            itemsize: int = 2) -> Cost:
    """x and y, B and C in ``itemsize``, fp32 a read and the fp32 final
    state written; per (batch, head, chunk) the products C B^T, att x,
    C S^T and the state update."""
    nbytes = 2 * b * t * h * p * itemsize + b * t * h * 4 \
        + 2 * b * t * g * n * itemsize + b * h * p * n * 4
    per_chunk = 2 * chunk * chunk * n + 2 * chunk * chunk * p \
        + 2 * 2 * chunk * n * p
    return nbytes, b * h * -(-t // chunk) * per_chunk


def ssd_bwd(b: int, t: int, h: int, p: int, g: int, n: int, chunk: int, *,
            itemsize: int = 2) -> Cost:
    """x, dy, B and C read and dx, dB and dC written in ``itemsize``, fp32 a
    read and da written; per (batch, head, chunk) the products C B^T,
    dy x^T, att^T dy, dS B, E C, dS^T x, E B, S^T dy, dy C^T (the state
    gradient) and x B^T (the recomputed state)."""
    nbytes = 3 * b * t * h * p * itemsize + 2 * b * t * h * 4 \
        + 4 * b * t * g * n * itemsize
    per_chunk = 2 * (3 * chunk * chunk * n + 2 * chunk * chunk * p
                     + 5 * chunk * p * n)
    return nbytes, b * h * -(-t // chunk) * per_chunk


# ---------------------------------------------------------------------------
# the meta branches' tally
# ---------------------------------------------------------------------------

class Tally:
    """Kernel calls, bytes and operations credited by name."""

    def __init__(self) -> None:
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.flops: Dict[str, int] = {}

    def add(self, name: str, cost: Cost) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0) + cost[0]
        self.flops[name] = self.flops.get(name, 0) + cost[1]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())


_TALLIES: List[Tally] = []


@contextlib.contextmanager
def tally() -> Iterator[Tally]:
    """Within: every kernel call a meta branch stands in for is credited to
    the yielded :class:`Tally` (and to any enclosing one)."""
    t = Tally()
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.remove(t)


def credit(name: str, cost: Cost) -> None:
    """Credit one call of kernel ``name`` to every open tally."""
    for t in _TALLIES:
        t.add(name, cost)
