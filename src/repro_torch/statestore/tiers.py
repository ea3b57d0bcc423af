"""Storage tiers: where snapshots live and what touching them costs.

The counterpart of ``repro.statestore.tiers``.  TierCheck's tier model:
state flows through a hierarchy of stores with very different
capacity/latency/bandwidth points — peer host **memory** (almost free, lost
when the host dies), **local disk** (survives process death, costs a
serialize), and **remote** storage (survives anything, costs the paper's
500 Mb/s link).  Each tier pairs a container with the
:class:`~repro_torch.core.walltime.TierSpec` that prices it, so recovery
wall-clock is computed from the tier actually serving the restore.

``MemoryTier`` also models *placement*: every snapshot is pinned to a host
(a pipeline-stage index), and :meth:`drop_host` wipes everything that host
held — what a node failure does to in-memory replicas (FFTrainer's failure
mode).

The disk tiers stream a snapshot to its file leaf by leaf and read it back
the same way, so a save or restore holds one copy of the state in host
memory, not two.
"""
from __future__ import annotations

import os
import random
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

from repro_torch import telemetry
from repro_torch.core.walltime import TierSpec
from repro_torch.statestore import codec
from repro_torch.statestore.codec import Snapshot


class TierError(RuntimeError):
    """A tier operation failed (missing key, blob over capacity...)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + jitter for transient I/O.

    Only transient errors are retried (``OSError`` except a missing file); a
    corrupted snapshot (``CodecError``) is data, not weather, and fails at
    once so that the store can fall back to the next snapshot.  Each retry
    emits a ``tier_retry`` telemetry event; a restore is priced once by the
    serving tier's spec, however many attempts it took.
    """

    attempts: int = 3          # total tries, including the first
    base_delay_s: float = 0.01
    max_delay_s: float = 0.5
    jitter: float = 0.5        # +- fraction of the backoff randomized

    def delay_s(self, attempt: int, u: float) -> float:
        """Backoff before retry ``attempt`` (1-based), ``u`` in [0, 1)."""
        d = min(self.base_delay_s * 2.0 ** (attempt - 1), self.max_delay_s)
        return max(d * (1.0 + self.jitter * (2.0 * u - 1.0)), 0.0)


class StorageTier:
    """Interface + shared pricing.  Keys are ``(shard_id, step)`` pairs."""

    kind = "abstract"

    def __init__(self, spec: TierSpec):
        self.spec = spec

    @property
    def name(self) -> str:
        return self.spec.name

    # ---- pricing ------------------------------------------------------
    def read_time_s(self, nbytes: float) -> float:
        return self.spec.read_time_s(nbytes)

    def write_time_s(self, nbytes: float) -> float:
        return self.spec.write_time_s(nbytes)

    # ---- container contract ------------------------------------------
    def put(self, snap: Snapshot, host: Optional[int] = None) -> None:
        raise NotImplementedError

    def get(self, shard_id: str, step: int) -> Snapshot:
        raise NotImplementedError

    def delete(self, shard_id: str, step: int) -> None:
        raise NotImplementedError

    def steps(self, shard_id: str) -> List[int]:
        """Steps available for ``shard_id``, ascending."""
        raise NotImplementedError

    def shard_ids(self) -> List[str]:
        """Every shard id with at least one snapshot in this tier."""
        raise NotImplementedError

    def has(self, shard_id: str, step: int) -> bool:
        return step in self.steps(shard_id)

    def used_bytes(self) -> int:
        raise NotImplementedError

    def drop_host(self, host: int) -> int:
        """Forget everything placed on ``host``; returns #snapshots lost.
        Only meaningful for memory tiers (disk survives its host here)."""
        return 0

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.name!r}, "
                f"used={self.used_bytes()}B)")


class MemoryTier(StorageTier):
    """Peer-host-memory tier: snapshots by reference, pinned to a host.

    Capacity is enforced by evicting the oldest snapshots (insertion
    order); a single snapshot larger than the tier raises.  An evicted
    snapshot's buffers go back to PyTorch's pinned-memory cache, which the
    next :func:`~repro_torch.statestore.codec.host_snapshot` draws from;
    a snapshot the tier still holds is never reused.
    """

    kind = "memory"

    def __init__(self, spec: TierSpec):
        super().__init__(spec)
        self._items: "OrderedDict[Tuple[str, int], Tuple[Snapshot, Optional[int]]]" = OrderedDict()

    def put(self, snap: Snapshot, host: Optional[int] = None) -> None:
        if snap.nbytes > self.spec.capacity_bytes:
            raise TierError(
                f"snapshot {snap.shard_id}@{snap.step} ({snap.nbytes}B) "
                f"exceeds tier {self.name!r} capacity "
                f"({self.spec.capacity_bytes}B)")
        key = (snap.shard_id, snap.step)
        self._items.pop(key, None)
        self._items[key] = (snap, host)
        while self.used_bytes() > self.spec.capacity_bytes:
            self._items.popitem(last=False)

    def get(self, shard_id: str, step: int) -> Snapshot:
        try:
            return self._items[(shard_id, step)][0]
        except KeyError:
            raise TierError(f"{shard_id}@{step} not in tier {self.name!r}") \
                from None

    def delete(self, shard_id: str, step: int) -> None:
        self._items.pop((shard_id, step), None)

    def steps(self, shard_id: str) -> List[int]:
        return sorted(s for (sid, s) in self._items if sid == shard_id)

    def shard_ids(self) -> List[str]:
        return sorted({sid for (sid, _) in self._items})

    def used_bytes(self) -> int:
        return sum(snap.nbytes for snap, _ in self._items.values())

    def drop_host(self, host: int) -> int:
        doomed = [k for k, (_, h) in self._items.items() if h == host]
        for k in doomed:
            del self._items[k]
        return len(doomed)


class DiskTier(StorageTier):
    """Local-disk tier: encoded snapshots as atomically-renamed files.

    ``template`` sets the filename layout, so that the checkpoint directory
    format (``ckpt_<step>.npz``, implicit shard "full") is served by the
    same tier as the sharded store layout (``<shard>-<step>.npz``).
    Interrupted writes leave ``*.tmp`` files that are swept on startup
    (:meth:`clean_stale_tmp`) and never match the step-listing pattern.
    ``retry`` bounds the attempts at a transient I/O error; None makes the
    first one fail.
    """

    kind = "disk"
    TMP_SUFFIX = ".tmp"

    def __init__(self, spec: TierSpec, directory: str,
                 template: str = "{shard}-{step:08d}.npz",
                 retry: Optional[RetryPolicy] = RetryPolicy()):
        super().__init__(spec)
        self.dir = directory
        self.template = template
        self.retry = retry
        # injectable for deterministic tests (monkeypatch to skip waits)
        self._sleep: Callable[[float], None] = time.sleep
        self._retry_rng = random.Random(0xFA11)
        pattern = (re.escape(template)
                   .replace(re.escape("{shard}"), r"(?P<shard>[\w.]+)")
                   .replace(re.escape("{step:08d}"), r"(?P<step>\d{8})"))
        self._pattern = re.compile(pattern + "$")
        self._lock = threading.Lock()
        #: tmp leftovers from interrupted saves swept at startup
        self.cleaned_on_init: List[str] = (
            self.clean_stale_tmp() if os.path.isdir(directory) else [])

    # ---- filenames ----------------------------------------------------
    def _path(self, shard_id: str, step: int) -> str:
        name = self.template.format(shard=shard_id, step=step)
        return os.path.join(self.dir, name)

    def _listing(self) -> List[Tuple[str, int, str]]:
        if not os.path.isdir(self.dir):
            return []
        out = []
        for f in os.listdir(self.dir):
            m = self._pattern.match(f)
            if m:
                groups = m.groupdict()
                out.append((groups.get("shard", "full"),
                            int(groups["step"]), f))
        return out

    def clean_stale_tmp(self) -> List[str]:
        """Remove leftover ``*.tmp`` files from interrupted saves."""
        removed = []
        if not os.path.isdir(self.dir):
            return removed
        for f in os.listdir(self.dir):
            # covers "<name>.npz.tmp" and the legacy checkpointer's
            # "<name>.npz.tmp.npz" leftovers alike
            if self.TMP_SUFFIX in f and not self._pattern.match(f):
                os.remove(os.path.join(self.dir, f))
                removed.append(f)
        return removed

    # ---- raw I/O seams (fault-injecting test tiers override these) ----
    def _write(self, path: str, snap: Snapshot) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = path + self.TMP_SUFFIX
        with open(tmp, "wb") as f:
            codec.write(snap, f)
        os.replace(tmp, path)

    def _read(self, path: str) -> Snapshot:
        with open(path, "rb") as f:
            return codec.read(f)   # raises CodecError on corruption

    def _with_retry(self, op: str, shard_id: str, step: int,
                    fn: Callable[[], Any]) -> Any:
        """Run one I/O primitive under the tier's retry policy.

        Transient ``OSError``s back off exponentially (with jitter) and
        retry up to ``attempts`` total tries; a missing file is state, not
        weather, and propagates at once.  Exhausted retries surface as
        :class:`TierError`, so the store's fallback chain (next snapshot,
        next tier) engages as for any other tier miss.
        """
        attempt = 1
        while True:
            try:
                return fn()
            except FileNotFoundError:
                raise
            except OSError as e:
                if self.retry is None or attempt >= self.retry.attempts:
                    raise TierError(
                        f"tier {self.name!r} {op} {shard_id}@{step} failed "
                        f"after {attempt} attempt(s): {e}") from e
                delay = self.retry.delay_s(attempt, self._retry_rng.random())
                telemetry.emit("tier_retry", tier=self.name, op=op,
                               shard_id=shard_id, step=step,
                               attempt=attempt, delay_s=delay)
                self._sleep(delay)
                attempt += 1

    # ---- container contract ------------------------------------------
    def put(self, snap: Snapshot, host: Optional[int] = None) -> None:
        if snap.nbytes > self.spec.capacity_bytes:
            raise TierError(
                f"snapshot {snap.shard_id}@{snap.step} exceeds tier "
                f"{self.name!r} capacity")
        with self._lock:
            path = self._path(snap.shard_id, snap.step)
            self._with_retry("put", snap.shard_id, snap.step,
                             lambda: self._write(path, snap))

    def get(self, shard_id: str, step: int) -> Snapshot:
        path = self._path(shard_id, step)
        if not os.path.exists(path):
            raise TierError(f"{shard_id}@{step} not in tier {self.name!r} "
                            f"({path} missing)")
        snap = self._with_retry("get", shard_id, step,
                                lambda: self._read(path))
        # trust the filename over the manifest (files can be renamed)
        snap.shard_id, snap.step = shard_id, step
        return snap

    def delete(self, shard_id: str, step: int) -> None:
        with self._lock:
            path = self._path(shard_id, step)
            if os.path.exists(path):
                os.remove(path)

    def steps(self, shard_id: str) -> List[int]:
        return sorted(s for sid, s, _ in self._listing() if sid == shard_id)

    def shard_ids(self) -> List[str]:
        return sorted({sid for sid, _, _ in self._listing()})

    def used_bytes(self) -> int:
        if not os.path.isdir(self.dir):
            return 0
        return sum(os.path.getsize(os.path.join(self.dir, f))
                   for _, _, f in self._listing())


class RemoteTier(DiskTier):
    """"Remote" storage: the mechanics of :class:`DiskTier` (no object
    store here), priced with remote latency/bandwidth — the paper's
    500 Mb/s non-faulty storage link."""

    kind = "remote"
