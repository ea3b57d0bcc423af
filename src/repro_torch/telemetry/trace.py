"""Chrome ``trace_event`` export (the counterpart of
``repro.telemetry.trace``).

The recorder's spans become ``"ph": "X"`` (complete) events and the
structured event stream becomes ``"ph": "i"`` (instant) markers, all in
one process track with per-thread rows — the JSON loads directly in
Perfetto / ``chrome://tracing``.  Timestamps are microseconds since the
recorder started (the ``trace_event`` clock domain is opaque, only
deltas matter).

Format reference: the Trace Event Format spec ("JSON Object Format" —
``{"traceEvents": [...]}``).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

PID = 1  # single-process runs: one constant pid keeps the file stable


def chrome_trace(spans: Iterable[dict],
                 events: Iterable[dict] = ()) -> Dict[str, Any]:
    """Build the ``{"traceEvents": [...]}`` object from recorder spans
    (``name``/``cat``/``ts_us``/``dur_us``/``tid``/``args`` dicts) and
    structured events (instant markers at their ``t_s``)."""
    out: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
        "args": {"name": "repro_torch"},
    }]
    # compact the OS thread ids into small stable row numbers
    tid_map: Dict[int, int] = {}

    def row(tid: int) -> int:
        if tid not in tid_map:
            tid_map[tid] = len(tid_map)
        return tid_map[tid]

    for s in spans:
        out.append({
            "name": s["name"], "cat": s.get("cat", "repro"), "ph": "X",
            "ts": round(float(s["ts_us"]), 3),
            "dur": round(float(s["dur_us"]), 3),
            "pid": PID, "tid": row(int(s.get("tid", 0))),
            "args": s.get("args", {}),
        })
    for e in events:
        out.append({
            "name": e.get("kind", "event"), "cat": "events", "ph": "i",
            "ts": round(float(e.get("t_s", 0.0)) * 1e6, 3),
            "pid": PID, "tid": 0, "s": "t",
            "args": {k: v for k, v in e.items()
                     if k not in ("v", "kind", "t_s")},
        })
    for tid, r in tid_map.items():
        out.append({
            "name": "thread_name", "ph": "M", "pid": PID, "tid": r,
            "args": {"name": "main" if r == 0 else f"thread-{r}"},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, recorder) -> str:
    with open(path, "w") as f:
        json.dump(recorder.chrome_trace(), f)
    return path


def load_chrome_trace(path: str) -> Dict[str, Any]:
    """Load + structurally validate a trace file; raises ``ValueError``
    when it would not render in a trace viewer."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError(f"{path}: not a trace_event JSON object")
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: traceEvents[{i}] is not an object")
        for field in ("name", "ph"):
            if field not in ev:
                raise ValueError(
                    f"{path}: traceEvents[{i}] missing {field!r}")
        if ev["ph"] in ("X", "i") and "ts" not in ev:
            raise ValueError(f"{path}: traceEvents[{i}] missing 'ts'")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"{path}: traceEvents[{i}] missing 'dur'")
    return doc
