"""``repro_torch.telemetry`` — structured events, metrics, and trace spans
for training under churn (the counterpart of ``repro.telemetry``, stdlib
only: the port imports nothing of ``repro`` and the report runs without
torch).

One process-wide :class:`Recorder` (disabled by default — every helper
below is a cheap no-op until :func:`configure` installs one) collects:

* **structured events** — schema-versioned JSONL records for step
  windows, failures, recoveries, snapshot saves/restores, simulated node
  churn, truncation (:mod:`repro_torch.telemetry.events`, the JAX
  package's schema);
* **counters / gauges / histograms** — :func:`inc` / :func:`gauge` /
  :func:`observe`;
* **trace spans** — host-side timings around the hot-path boundaries
  (window dispatch/drain, snapshot writes, restores, recovery execution,
  re-layouts, the simulator), exported as Chrome ``trace_event`` JSON for
  Perfetto (:mod:`repro_torch.telemetry.trace`);
* **derived run metrics** — goodput, per-strategy recovery breakdown,
  per-tier snapshot bytes, straggler stretch, MFU
  (:mod:`repro_torch.telemetry.metrics`), rendered by
  ``python -m repro_torch.telemetry.report``
  (:mod:`repro_torch.telemetry.report`).

The sites run on the host around a window's dispatch and drain, never
inside a captured step, and take only host values: a run with a recorder
installed launches the same kernels, makes the same host syncs and gives
the same bits as one without.
"""
from repro_torch.telemetry.events import (EVENT_KINDS, SCHEMA_VERSION,
                                          validate_events, validate_record)
from repro_torch.telemetry.log import log, set_verbosity, verbosity
from repro_torch.telemetry.metrics import compute_metrics, render_text
from repro_torch.telemetry.recorder import (Recorder, clock, complete,
                                            configure, emit, enabled, gauge,
                                            get_recorder, inc, observe,
                                            set_recorder, span, traced)
from repro_torch.telemetry.trace import chrome_trace, load_chrome_trace

__all__ = [
    "EVENT_KINDS", "SCHEMA_VERSION", "Recorder",
    "chrome_trace", "clock", "complete", "compute_metrics", "configure",
    "emit", "enabled", "gauge", "get_recorder", "inc", "load_chrome_trace",
    "log", "observe", "render_text", "set_recorder", "set_verbosity",
    "span", "traced", "validate_events", "validate_record", "verbosity",
]
