"""Run-level metrics derived from the structured event stream (the
counterpart of ``repro.telemetry.metrics``: the same metrics, computed the
same way).

Pure functions from a list of event records
(:mod:`repro_torch.telemetry.events` schema) to a JSON-able metrics object:

* **goodput** — effective optimization steps per wall iteration: the
  paper's headline axis (recovery strategies trade lost work against
  per-iteration overhead; goodput is what is left).
* **recovery breakdown per strategy** — count, measured host seconds spent
  executing recovery math, and modelled seconds charged for the failures
  (strategy ``failure_cost`` + node-dependent overhead).
* **snapshot bytes per tier** — saved / restored volume and priced read
  time per state-store tier (the TierCheck axis).
* **straggler stretch** — mean / max iteration-time multiplier actually
  paid (the simulator's slowest-participant pricing).
* **MFU estimate** — per-family FLOPs (``6 * active_params * tokens`` for
  training) over measured host time, against a peak-FLOPs reference.

Everything here is stdlib-only so the report CLI works on machines
without torch installed.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from repro_torch.telemetry.events import SCHEMA_VERSION


def _by_kind(events: Iterable[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for e in events:
        out.setdefault(e.get("kind", "?"), []).append(e)
    return out


def compute_metrics(events: List[dict], *,
                    peak_flops: Optional[float] = None) -> Dict[str, Any]:
    """Derive the run-level metrics object from an event stream.

    ``peak_flops`` (FLOP/s) turns the achieved-FLOPs rate into an MFU
    fraction; without it only the achieved rate is reported.
    """
    by = _by_kind(events)
    out: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "counts": {k: len(v) for k, v in sorted(by.items())},
    }

    start = by.get("run_start", [None])[0]
    end = by.get("run_end", [None])[-1]

    # ---- goodput ------------------------------------------------------
    goodput: Optional[float] = None
    if end is not None and end.get("wall_iters"):
        goodput = end["effective_steps"] / end["wall_iters"]
    elif by.get("step_window"):
        last = by["step_window"][-1]
        wall = last["wall_step"] + last["k"]
        if wall:
            goodput = last["effective_step"] / wall
    out["goodput"] = goodput
    if end is not None:
        out["effective_steps"] = end.get("effective_steps")
        out["wall_iters"] = end.get("wall_iters")
        out["dispatches"] = end.get("dispatches")
        out["modelled_wall_s"] = end.get("clock_s")
        out["truncated"] = bool(end.get("truncated", False))

    # ---- recovery breakdown per strategy ------------------------------
    recovery: Dict[str, Dict[str, Any]] = {}
    for e in by.get("recovery", ()):
        b = recovery.setdefault(e.get("strategy", "?"), {
            "count": 0, "stages": 0, "measured_s": 0.0})
        b["count"] += 1
        b["stages"] += max(len(e.get("stages", [])), 1)
        b["measured_s"] += float(e.get("duration_s", 0.0))
    modelled = sum(float(e.get("cost_s", 0.0)) + float(e.get("overhead_s", 0.0))
                   for e in by.get("failure", ()))
    reps = by.get("repartition", ())
    out["recovery"] = {
        "by_strategy": recovery,
        "events": len(by.get("recovery", ())),
        "failures": len(by.get("failure", ())),
        "modelled_cost_s": modelled,
        "repartitions": len(reps),
    }

    # ---- elastic re-layouts -------------------------------------------
    out["repartition"] = {
        "count": len(reps),
        "shrinks": sum(1 for e in reps if e.get("direction") == "shrink"),
        "grows": sum(1 for e in reps if e.get("direction") == "grow"),
        "moved_layers": sum(int(e.get("moved_layers", 0)) for e in reps),
        "moved_bytes": sum(float(e.get("nbytes", 0.0)) for e in reps),
        "cost_s": sum(float(e.get("cost_s", 0.0)) for e in reps),
    }

    # ---- transient tier I/O retries -----------------------------------
    retries: Dict[str, int] = {}
    for e in by.get("tier_retry", ()):
        key = f"{e.get('tier', '?')}/{e.get('op', '?')}"
        retries[key] = retries.get(key, 0) + 1
    out["tier_retries"] = retries

    # ---- snapshot volume per tier -------------------------------------
    tiers: Dict[str, Dict[str, Any]] = {}
    for e in by.get("snapshot_save", ()):
        t = tiers.setdefault(e.get("tier", "?"), {
            "saves": 0, "saved_bytes": 0, "restores": 0,
            "restored_bytes": 0, "read_time_s": 0.0})
        t["saves"] += 1
        t["saved_bytes"] += int(e.get("nbytes", 0))
    for e in by.get("snapshot_restore", ()):
        t = tiers.setdefault(e.get("tier", "?"), {
            "saves": 0, "saved_bytes": 0, "restores": 0,
            "restored_bytes": 0, "read_time_s": 0.0})
        t["restores"] += 1
        t["restored_bytes"] += int(e.get("nbytes", 0))
        t["read_time_s"] += float(e.get("read_time_s", 0.0))
    out["snapshots"] = {"by_tier": tiers}

    # ---- straggler stretch --------------------------------------------
    # step_window.stretch is the window-mean iteration factor; weight by k
    total_k = sum(int(e.get("k", 0)) for e in by.get("step_window", ()))
    if total_k:
        mean = sum(float(e.get("stretch", 1.0)) * int(e.get("k", 0))
                   for e in by["step_window"]) / total_k
        mx = max(float(e.get("stretch", 1.0)) for e in by["step_window"])
        out["straggler"] = {"mean_stretch": mean, "max_stretch": mx}
    else:
        out["straggler"] = {"mean_stretch": None, "max_stretch": None}

    # ---- node churn (simulated cluster) -------------------------------
    churn: Dict[str, int] = {}
    for e in by.get("sim_node", ()):
        churn[e.get("what", "?")] = churn.get(e.get("what", "?"), 0) + 1
    out["node_churn"] = churn

    # ---- MFU ----------------------------------------------------------
    mfu: Dict[str, Any] = {"flops_per_step": None,
                           "achieved_flops_per_s": None, "mfu": None}
    if start is not None and end is not None:
        fps = float(start.get("flops_per_step", 0.0))
        elapsed = float(end.get("t_s", 0.0)) - float(start.get("t_s", 0.0))
        mfu["flops_per_step"] = fps
        mfu["measured_wall_s"] = elapsed
        if fps > 0 and elapsed > 0:
            achieved = fps * end.get("effective_steps", 0) / elapsed
            mfu["achieved_flops_per_s"] = achieved
            if peak_flops:
                mfu["mfu"] = achieved / peak_flops
                mfu["peak_flops"] = peak_flops
    out["mfu"] = mfu
    return out


# ---------------------------------------------------------------------------
# strict contract + rendering (shared by the report CLI and the CI job)
# ---------------------------------------------------------------------------

def strict_problems(metrics: Dict[str, Any]) -> List[str]:
    """What a ``--strict`` report refuses: the metrics a paper-scenario run
    must produce (goodput, a per-strategy recovery breakdown with at least
    one recovery event, a snapshot section)."""
    problems = []
    g = metrics.get("goodput")
    if not isinstance(g, (int, float)) or not (0.0 < g <= 1.0):
        problems.append(f"goodput missing or out of (0, 1]: {g!r}")
    rec = metrics.get("recovery") or {}
    if not rec.get("events"):
        problems.append("no recovery events recorded")
    if not rec.get("by_strategy"):
        problems.append("recovery breakdown per strategy is empty")
    if "snapshots" not in metrics or "by_tier" not in (
            metrics.get("snapshots") or {}):
        problems.append("snapshot per-tier section missing")
    return problems


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def render_text(metrics: Dict[str, Any]) -> str:
    lines = ["== repro_torch telemetry report =="]
    g = metrics.get("goodput")
    lines.append(f"goodput           : "
                 f"{g:.4f} effective steps / wall iter" if g is not None
                 else "goodput           : n/a")
    if metrics.get("wall_iters") is not None:
        lines.append(f"progress          : {metrics.get('effective_steps')} "
                     f"effective steps over {metrics.get('wall_iters')} wall "
                     f"iters in {metrics.get('dispatches')} dispatches"
                     + (" [TRUNCATED]" if metrics.get("truncated") else ""))
    if metrics.get("modelled_wall_s") is not None:
        lines.append(f"modelled wall     : "
                     f"{metrics['modelled_wall_s'] / 3600:.2f} h")
    rec = metrics.get("recovery") or {}
    lines.append(f"failures          : {rec.get('failures', 0)} events, "
                 f"modelled cost {rec.get('modelled_cost_s', 0.0):.1f} s")
    for name, b in sorted((rec.get("by_strategy") or {}).items()):
        lines.append(f"  recovery[{name}] : {b['count']} events / "
                     f"{b['stages']} stages, measured {b['measured_s']:.4f} s")
    tiers = (metrics.get("snapshots") or {}).get("by_tier") or {}
    for name, t in sorted(tiers.items()):
        lines.append(
            f"  tier[{name}]   : {t['saves']} saves "
            f"({_fmt_bytes(t['saved_bytes'])}), {t['restores']} restores "
            f"({_fmt_bytes(t['restored_bytes'])}, "
            f"{t['read_time_s']:.3f} s priced)")
    rep = metrics.get("repartition") or {}
    if rep.get("count"):
        lines.append(f"repartitions      : {rep['count']} "
                     f"({rep['shrinks']} shrink / {rep['grows']} grow), "
                     f"{rep['moved_layers']} layers moved "
                     f"({_fmt_bytes(rep['moved_bytes'])}), "
                     f"{rep['cost_s']:.1f} s priced")
    retries = metrics.get("tier_retries") or {}
    if retries:
        lines.append("tier retries      : " + ", ".join(
            f"{k}={v}" for k, v in sorted(retries.items())))
    st = metrics.get("straggler") or {}
    if st.get("mean_stretch") is not None:
        lines.append(f"straggler stretch : mean {st['mean_stretch']:.3f}, "
                     f"max {st['max_stretch']:.3f}")
    churn = metrics.get("node_churn") or {}
    if churn:
        lines.append("node churn        : " + ", ".join(
            f"{k}={v}" for k, v in sorted(churn.items())))
    mfu = metrics.get("mfu") or {}
    if mfu.get("achieved_flops_per_s"):
        lines.append(f"achieved FLOP/s   : "
                     f"{mfu['achieved_flops_per_s']:.3e}")
        if mfu.get("mfu") is not None:
            lines.append(f"MFU               : {mfu['mfu']:.2%} of "
                         f"{mfu['peak_flops']:.2e} FLOP/s peak")
    counts = metrics.get("counts") or {}
    lines.append("events            : " + ", ".join(
        f"{k}={v}" for k, v in sorted(counts.items())))
    return "\n".join(lines)
