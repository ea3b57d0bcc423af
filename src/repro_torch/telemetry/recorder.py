"""The process-wide telemetry recorder (the counterpart of
``repro.telemetry.recorder``).

One :class:`Recorder` owns everything a run produces: counters / gauges /
histogram summaries, the structured JSONL event stream
(:mod:`repro_torch.telemetry.events`), and host-side trace *spans* exported
as Chrome ``trace_event`` JSON (:mod:`repro_torch.telemetry.trace`).
Installation is process-global (``configure()`` / ``set_recorder()``) so
deeply nested layers — the trainer's window loop, the async snapshot writer
thread, the cluster simulator — all reach the same sink through the
module-level helpers without threading a handle through every constructor.

**Overhead contract.**  Telemetry is *disabled by default* and the
module-level helpers are the only thing hot paths call: when no recorder
is installed, :func:`emit` / :func:`inc` / :func:`complete` are a single
``None`` check and :func:`span` returns one shared reusable null context —
no allocation, no lock, no clock read.  A fused window must stay within 2%
of its telemetry-free time, which is why nothing here may run work on the
disabled path.

**Host-side only.**  Spans and events record *around* the dispatch and
drain of a window, never inside a captured step, and event payloads must
already be host values (the drained ring's numpy scalars, python numbers).
A tensor in a payload would synchronize the card in the serializer, so the
sanitizer refuses any value whose type comes from ``torch`` with a
``TypeError`` (by its module name: this package never imports torch, so
the report runs on a host without it).

Thread-safety: the :class:`~repro_torch.statestore.snapshot.AsyncSnapshotter`
worker emits from its own thread; all mutation happens under one lock and
per-thread ids are preserved so the Chrome trace shows background writes
on their own track.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import numbers
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.telemetry.events import SCHEMA_VERSION

EVENTS_FILENAME = "events.jsonl"
TRACE_FILENAME = "trace.json"


def _jsonable(v: Any) -> Any:
    """Coerce host scalars (python + numpy) to JSON primitives.

    A value whose type comes from ``torch`` (a tensor above all, also a
    dtype, a device or a size) raises ``TypeError``: reading a tensor on
    the card would synchronize it, so a tensor in an event is always a bug.
    Anything else unknown becomes ``str(v)`` instead of a guess.
    """
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if type(v).__module__.split(".")[0] == "torch":
        raise TypeError(f"telemetry payload of type {type(v).__qualname__} "
                        "from torch: pass host values (a tensor here would "
                        "synchronize the card)")
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    item = getattr(v, "item", None)          # numpy scalars outside numbers
    if item is not None and getattr(v, "ndim", 1) == 0:
        try:
            return _jsonable(item())
        except (TypeError, ValueError):
            pass
    return str(v)


class _HistSummary:
    """Streaming histogram summary: count / sum / min / max (no samples
    are retained — the event stream is the raw record)."""

    __slots__ = ("count", "total", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.total,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "mean": self.total / self.count if self.count else 0.0}


class Recorder:
    """Counters, gauges, histograms, events, and trace spans for one run."""

    def __init__(self, run_dir: Optional[str] = None, *,
                 stream: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.run_dir = run_dir
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, _HistSummary] = {}
        self.events: List[dict] = []
        self.spans: List[dict] = []
        self._file: Optional[io.TextIOBase] = None
        if run_dir is not None and stream:
            os.makedirs(run_dir, exist_ok=True)
            self._file = open(os.path.join(run_dir, EVENTS_FILENAME), "w")

    # ---- clock --------------------------------------------------------
    def now(self) -> float:
        """Host seconds since the recorder was created."""
        return self._clock() - self._t0

    # ---- metrics ------------------------------------------------------
    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self.hists.setdefault(name, _HistSummary()).add(float(value))

    # ---- events -------------------------------------------------------
    def event(self, kind: str, **fields: Any) -> dict:
        rec = {"v": SCHEMA_VERSION, "kind": kind, "t_s": self.now()}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        with self._lock:
            self.events.append(rec)
            self.counters[f"events.{kind}"] = \
                self.counters.get(f"events.{kind}", 0) + 1
            if self._file is not None:
                json.dump(rec, self._file)
                self._file.write("\n")
        return rec

    # ---- spans --------------------------------------------------------
    def complete(self, name: str, t0: float, *, cat: str = "repro",
                 **args: Any) -> None:
        """Record a finished span that started at host time ``t0``
        (a value previously obtained from :func:`clock`)."""
        t1 = self._clock()
        with self._lock:
            self.spans.append({
                "name": name, "cat": cat,
                "ts_us": (t0 - self._t0) * 1e6,
                "dur_us": (t1 - t0) * 1e6,
                "tid": threading.get_ident(),
                "args": {k: _jsonable(v) for k, v in args.items()},
            })

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "repro", **args: Any):
        t0 = self._clock()
        try:
            yield
        finally:
            self.complete(name, t0, cat=cat, **args)

    # ---- export -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time metric values (JSON-able)."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.summary()
                               for k, h in self.hists.items()},
            }

    def chrome_trace(self) -> Dict[str, Any]:
        from repro_torch.telemetry.trace import chrome_trace
        with self._lock:
            spans = list(self.spans)
            events = list(self.events)
        return chrome_trace(spans, events)

    def write_chrome_trace(self, path: Optional[str] = None) -> str:
        from repro_torch.telemetry.trace import write_chrome_trace
        if path is None:
            if self.run_dir is None:
                raise ValueError("no path given and recorder has no run_dir")
            path = os.path.join(self.run_dir, TRACE_FILENAME)
        return write_chrome_trace(path, self)

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# ---------------------------------------------------------------------------
# process-global installation + the hot-path helpers
# ---------------------------------------------------------------------------

_RECORDER: Optional[Recorder] = None
_NULL_SPAN = contextlib.nullcontext()     # shared, reentrant, allocation-free


def enabled() -> bool:
    return _RECORDER is not None


def get_recorder() -> Optional[Recorder]:
    return _RECORDER


def set_recorder(rec: Optional[Recorder]) -> Optional[Recorder]:
    """Install ``rec`` process-wide; returns the previous recorder (restore
    it in a ``finally`` when scoping telemetry to a test)."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, rec
    return prev


def configure(run_dir: Optional[str] = None, *,
              stream: bool = True) -> Recorder:
    """Create a :class:`Recorder` (streaming JSONL into ``run_dir`` when
    given) and install it process-wide."""
    rec = Recorder(run_dir, stream=stream)
    set_recorder(rec)
    return rec


def emit(kind: str, **fields: Any) -> None:
    r = _RECORDER
    if r is not None:
        r.event(kind, **fields)


def inc(name: str, n: float = 1) -> None:
    r = _RECORDER
    if r is not None:
        r.inc(name, n)


def gauge(name: str, value: float) -> None:
    r = _RECORDER
    if r is not None:
        r.gauge(name, value)


def observe(name: str, value: float) -> None:
    r = _RECORDER
    if r is not None:
        r.observe(name, value)


def span(name: str, *, cat: str = "repro", **args: Any):
    """Context manager timing a host-side region (no-op when disabled)."""
    r = _RECORDER
    if r is None:
        return _NULL_SPAN
    return r.span(name, cat=cat, **args)


def clock() -> float:
    """Raw host clock for the manual-span pattern::

        t0 = telemetry.clock()
        ... dispatch ...
        telemetry.complete("window_dispatch", t0, k=k)

    Used where the span's arguments are known only after the region, or
    where a ``with`` block would wrap more than the region.  Returns 0.0
    when disabled — :func:`complete` ignores it then anyway.
    """
    r = _RECORDER
    if r is None:
        return 0.0
    return r._clock()


def complete(name: str, t0: float, *, cat: str = "repro",
             **args: Any) -> None:
    r = _RECORDER
    if r is not None:
        r.complete(name, t0, cat=cat, **args)


def traced(name: str, *, cat: str = "repro"):
    """Decorator form of :func:`span` for whole-function spans."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            r = _RECORDER
            if r is None:
                return fn(*a, **kw)
            with r.span(name, cat=cat):
                return fn(*a, **kw)
        return wrapper
    return deco
