"""The structured-event schema (a copy of ``repro.telemetry.events``: the
same kinds, fields and types, so that either package's report reads the
other's run directory).

Every record the :class:`~repro_torch.telemetry.recorder.Recorder` emits is one
JSON object per line (JSONL) with three envelope fields — ``v`` (schema
version), ``kind`` (one of :data:`EVENT_KINDS`), ``t_s`` (host seconds
since the recorder started) — plus the kind's required payload below.
Extra fields are always allowed (schemas grow by addition); *missing*
required fields or wrong primitive types are validation errors, which is
what lets ``repro_torch.telemetry.report --strict`` refuse a malformed run
directory instead of silently producing nonsense metrics.

The schema is consumed in three places: the recorder stamps the envelope,
:mod:`repro_torch.telemetry.metrics` derives run-level metrics from the stream,
and :func:`validate_record` gates both the report CLI and the test suite.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

SCHEMA_VERSION = 2   # v2 adds: repartition, tier_retry

_NUM = (int, float)
_INT = (int,)
_STR = (str,)
_BOOL = (bool,)

# kind -> {required field: allowed primitive types}
EVENT_FIELDS: Dict[str, Dict[str, Tuple[type, ...]]] = {
    # run lifecycle -------------------------------------------------------
    "run_start": {
        "arch": _STR, "strategy": _STR, "backend": _STR,
        "steps": _INT, "num_stages": _INT,
        "flops_per_step": _NUM, "tokens_per_step": _NUM,
    },
    "run_end": {
        "effective_steps": _INT, "wall_iters": _INT, "dispatches": _INT,
        "failures": _INT, "truncated": _BOOL, "clock_s": _NUM,
    },
    "truncation": {
        "wall_iters": _INT, "effective_step": _INT, "target_steps": _INT,
    },
    # hot path ------------------------------------------------------------
    "step_window": {
        "wall_step": _INT, "k": _INT, "effective_step": _INT,
        "loss": _NUM, "clock_s": _NUM, "stretch": _NUM,
    },
    "eval": {"step": _INT, "loss": _NUM, "clock_s": _NUM},
    # churn and recovery --------------------------------------------------
    "failure": {
        "wall_step": _INT, "stage": _INT,
        "cost_s": _NUM, "overhead_s": _NUM,
    },
    "recovery": {
        "wall_step": _INT, "stage": _INT, "strategy": _STR,
        "duration_s": _NUM, "stages": (list,),
    },
    "repartition": {
        "wall_step": _INT, "direction": _STR,   # "shrink" | "grow"
        "from_stages": _INT, "to_stages": _INT,
        "moved_layers": _INT, "nbytes": _NUM, "cost_s": _NUM,
    },
    # state store ---------------------------------------------------------
    "snapshot_save": {
        "step": _INT, "shard_id": _STR, "tier": _STR,
        "nbytes": _INT, "synchronous": _BOOL,
    },
    "snapshot_restore": {
        "step": _INT, "shard_id": _STR, "tier": _STR,
        "nbytes": _INT, "read_time_s": _NUM,
    },
    "tier_retry": {
        "tier": _STR, "op": _STR, "shard_id": _STR,
        "attempt": _INT, "delay_s": _NUM,
    },
    # simulated cluster ---------------------------------------------------
    "sim_node": {"what": _STR, "step": _INT, "stage": _INT, "node_id": _INT},
    "sim_run": {
        "scenario": _STR, "steps": _INT, "events": _INT,
        "suppressed": _INT, "total_hours": _NUM,
    },
    # logging -------------------------------------------------------------
    "log": {"message": _STR, "level": _INT},
}

EVENT_KINDS = frozenset(EVENT_FIELDS)


def validate_record(rec: Any) -> List[str]:
    """Problems with one event record (empty list = valid)."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, expected object"]
    problems: List[str] = []
    v = rec.get("v")
    if not isinstance(v, int):
        problems.append("missing/invalid schema version field 'v'")
    elif v > SCHEMA_VERSION:
        problems.append(f"schema version {v} is newer than supported "
                        f"{SCHEMA_VERSION}")
    if not isinstance(rec.get("t_s"), _NUM) or isinstance(
            rec.get("t_s"), bool):
        problems.append("missing/invalid timestamp field 't_s'")
    kind = rec.get("kind")
    if kind not in EVENT_FIELDS:
        problems.append(f"unknown event kind {kind!r}")
        return problems
    for name, types in EVENT_FIELDS[kind].items():
        if name not in rec:
            problems.append(f"{kind}: missing required field {name!r}")
        elif not isinstance(rec[name], types) or (
                isinstance(rec[name], bool) and bool not in types):
            problems.append(
                f"{kind}: field {name!r} is {type(rec[name]).__name__}, "
                f"expected {'/'.join(t.__name__ for t in types)}")
    return problems


def validate_events(records: Iterable[Any]) -> List[str]:
    """Flattened problems across a whole stream, prefixed by record index."""
    problems = []
    for i, rec in enumerate(records):
        problems.extend(f"event[{i}]: {p}" for p in validate_record(rec))
    return problems
