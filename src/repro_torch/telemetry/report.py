"""Run-directory report CLI (the counterpart of ``repro.telemetry.report``).

    PYTHONPATH=src python -m repro_torch.telemetry.report RUN_DIR \
        [--json] [--strict] [--peak-flops F]

``RUN_DIR`` is a ``--telemetry-dir`` produced by
``repro_torch.launch.train`` (or by ``repro.launch.train``: both packages
write the same schema), or any directory holding an ``events.jsonl``; a
path to the JSONL file itself also works.  The report validates every
record against the event schema, derives the run-level metrics (goodput,
per-strategy recovery breakdown, per-tier snapshot volume, straggler
stretch, MFU — see :mod:`repro_torch.telemetry.metrics`), and renders them
as text or JSON.

``--peak-flops`` has no default: MFU is reported only against a peak the
caller names, such as 989e12, the dense bf16 tensor-core peak of an NVIDIA
H100 80GB HBM3 (SXM, 700 W) by its datasheet.

``--strict`` is the CI contract: exit 2 on schema violations or a missing
or corrupt stream, exit 1 when the required metrics (goodput in (0, 1], at
least one recovery event with a per-strategy breakdown, the per-tier
snapshot section) are missing.

Stdlib-only on purpose: the report must run on hosts without torch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.telemetry.events import validate_events
from repro_torch.telemetry.metrics import (compute_metrics, render_text,
                                           strict_problems)
from repro_torch.telemetry.recorder import EVENTS_FILENAME


def load_events(path: str) -> List[dict]:
    """Events from a run directory or a JSONL file path."""
    if os.path.isdir(path):
        path = os.path.join(path, EVENTS_FILENAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no event stream at {path}")
    events = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
    return events


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.telemetry.report",
        description="summarize a telemetry run directory")
    ap.add_argument("run", help="run directory (or events.jsonl path)")
    ap.add_argument("--json", action="store_true",
                    help="emit the metrics object as JSON instead of text")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on schema violations or missing "
                         "required metrics (the CI contract)")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="peak FLOP/s of the device the run trained on, "
                         "for the MFU estimate (e.g. 989e12: the dense "
                         "bf16 datasheet peak of an NVIDIA H100 80GB HBM3 "
                         "at 700 W); omitted: no MFU")
    args = ap.parse_args(argv)

    try:
        events = load_events(args.run)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    problems = validate_events(events)
    if problems:
        for p in problems[:20]:
            print(f"schema: {p}", file=sys.stderr)
        if len(problems) > 20:
            print(f"schema: ... {len(problems) - 20} more", file=sys.stderr)
        if args.strict:
            return 2

    metrics = compute_metrics(events, peak_flops=args.peak_flops or None)
    if args.json:
        print(json.dumps(metrics, indent=1))
    else:
        print(render_text(metrics))

    if args.strict:
        missing = strict_problems(metrics)
        for p in missing:
            print(f"strict: {p}", file=sys.stderr)
        if missing:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
