"""Fault-injecting storage tiers for chaos tests (the counterpart of
``repro.statestore.faults``).

Transient I/O failures are injected *under* the retry seams
(:meth:`DiskTier._write` / :meth:`DiskTier._read`), so the tier's own
:class:`~repro_torch.statestore.tiers.RetryPolicy` is what absorbs them.
A plan is a per-operation countdown: the next ``times`` calls raise, then
the tier heals.

    tier = FaultInjectingDiskTier(spec, directory)
    tier._sleep = lambda s: None          # tests skip real backoff waits
    tier.inject("put", times=2)           # next two writes fail, then heal
    tier.inject("get", times=1, exc=PermissionError("throttled"))

Only used by tests; nothing in the production paths imports this module.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.statestore.codec import Snapshot
from repro_torch.statestore.tiers import DiskTier, RemoteTier


class _FaultPlanMixin:
    """Countdown-based fault injection shared by the flaky tier classes."""

    def _plan(self) -> Dict[str, list]:
        if not hasattr(self, "_fault_plan"):
            self._fault_plan: Dict[str, list] = {}
        return self._fault_plan

    def inject(self, op: str, times: int = 1,
               exc: Optional[BaseException] = None,
               exc_factory: Optional[Callable[[], BaseException]] = None
               ) -> None:
        """Arm the next ``times`` calls of ``op`` ("put" | "get") to raise.

        ``exc`` is raised every time (default a transient ``OSError``);
        ``exc_factory`` builds a fresh exception per failure.
        """
        if op not in ("put", "get"):
            raise ValueError(f"unknown op {op!r}; expected 'put' or 'get'")
        if exc_factory is None:
            def exc_factory():
                return exc if exc is not None else OSError(
                    f"injected transient {op} fault")
        self._plan()[op] = [times, exc_factory]

    def faults_remaining(self, op: str) -> int:
        entry = self._plan().get(op)
        return entry[0] if entry else 0

    def _maybe_fault(self, op: str) -> None:
        entry = self._plan().get(op)
        if entry and entry[0] > 0:
            entry[0] -= 1
            raise entry[1]()

    def _write(self, path: str, snap: Snapshot) -> None:
        self._maybe_fault("put")
        super()._write(path, snap)

    def _read(self, path: str) -> Snapshot:
        self._maybe_fault("get")
        return super()._read(path)


class FaultInjectingDiskTier(_FaultPlanMixin, DiskTier):
    """A :class:`DiskTier` whose file I/O fails on command."""


class FaultInjectingRemoteTier(_FaultPlanMixin, RemoteTier):
    """A :class:`RemoteTier` whose file I/O fails on command."""
