"""Asynchronous, double-buffered snapshot writes (the counterpart of
``repro.statestore.snapshot``).

The expensive parts of a checkpoint are the serialize + tier I/O, not the
host copy: :func:`~repro_torch.statestore.codec.host_snapshot` detaches the
state from the training tensors, after which encoding and disk/remote
writes can run on a background thread while training continues.  The queue
is bounded at ``depth`` in-flight writes (default 2, the double buffer):
if the writer falls behind, ``submit`` blocks.

Worker exceptions are captured and re-raised on the next ``flush()`` /
``submit()``, so an I/O failure cannot be silently swallowed.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from repro_torch import telemetry

_SENTINEL = object()


class SnapshotWriteError(RuntimeError):
    """A background tier write failed."""


class AsyncSnapshotter:
    """Runs tier-write thunks on a single background thread."""

    def __init__(self, depth: int = 2):
        self.depth = max(int(depth), 1)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name="statestore-snapshot",
                    daemon=True)
                self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                if self._error is None:  # fail-fast: skip after first error
                    # on this thread's own row of the Chrome trace
                    with telemetry.span("snapshot_write", cat="statestore",
                                        pending=self._q.qsize()):
                        item()
            except BaseException as e:  # noqa: BLE001 — reported on flush
                self._error = e
            finally:
                self._q.task_done()

    def _check_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise SnapshotWriteError(
                f"background snapshot write failed: {err!r}") from err

    # ---- public -------------------------------------------------------
    def submit(self, write: Callable[[], None]) -> None:
        """Enqueue a tier write; blocks when ``depth`` writes are already
        in flight (double-buffer backpressure)."""
        self._check_error()
        self._ensure_thread()
        self._q.put(write)

    def flush(self) -> None:
        """Wait for every submitted write to land (restores must see the
        freshest tier contents); re-raises any background failure."""
        if self._thread is not None:
            self._q.join()
        self._check_error()

    def close(self) -> None:
        """Flush and stop the worker thread."""
        if self._thread is not None and self._thread.is_alive():
            self._q.join()
            self._q.put(_SENTINEL)
            self._thread.join(timeout=30.0)
            self._thread = None
        self._check_error()
