"""``python -m repro_torch.analysis`` — run the port's lint engine from the
command line (the port's copy of ``repro.analysis.cli``).

    python -m repro_torch.analysis src/repro_torch examples chip_smoke.py --strict
    python -m repro_torch.analysis src/repro_torch --format json
    python -m repro_torch.analysis src/repro_torch --write-baseline

Exit codes: 0 clean (or non-strict), 1 new findings under ``--strict``,
2 usage/parse errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis import baseline as bl
from repro_torch.analysis.engine import (DEFAULT_EXCLUDES, Finding, all_rules,
                                   run_paths)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the PyTorch port (captured-window, "
                    "process-group, generator, dispatch and kernel-binding "
                    "invariants).")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when any non-baselined finding remains")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--baseline", default=bl.DEFAULT_BASELINE,
                    help=f"baseline file (default: {bl.DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file entirely")
    ap.add_argument("--write-baseline", action="store_true",
                    help="snapshot current findings into the baseline file")
    ap.add_argument("--exclude", action="append", default=None,
                    metavar="NAME",
                    help="directory names to skip (repeatable; default: "
                         + ", ".join(DEFAULT_EXCLUDES))
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rules = all_rules()
    if args.list_rules:
        width = max(len(r) for r in rules)
        for rid, rule in sorted(rules.items()):
            print(f"{rid.ljust(width)}  {rule.doc}")  # repro: allow[no-bare-print]
        return 0
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - set(rules)
        if unknown:
            # repro: allow[no-bare-print]
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = {k: v for k, v in rules.items() if k in wanted}

    excludes = tuple(args.exclude) if args.exclude else DEFAULT_EXCLUDES
    reports = run_paths(args.paths, rules=rules, excludes=excludes)
    findings: List[Finding] = [f for r in reports for f in r.findings]
    nsupp = sum(r.suppressed for r in reports)
    errors = [r for r in reports if r.error]

    if args.write_baseline:
        bl.write_baseline(args.baseline, findings)
        # repro: allow[no-bare-print]
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = {} if args.no_baseline else bl.load_baseline(args.baseline)
    new, old = bl.split_by_baseline(findings, baseline)

    if args.format == "json":
        print(json.dumps({  # repro: allow[no-bare-print]
            "files": len(reports),
            "findings": [f.to_json() for f in new],
            "baselined": [f.to_json() for f in old],
            "suppressed": nsupp,
            "errors": [{"path": r.path, "error": r.error} for r in errors],
        }, indent=1))
    else:
        for f in new:
            print(f.format())  # repro: allow[no-bare-print]
        for r in errors:
            print(f"{r.path}: {r.error}", file=sys.stderr)  # repro: allow[no-bare-print]
        tail = (f"{len(reports)} file(s): {len(new)} finding(s)"
                f" ({len(old)} baselined, {nsupp} suppressed)")
        print(tail if new or old or nsupp else  # repro: allow[no-bare-print]
              f"{len(reports)} file(s): clean")
    if errors:
        return 2
    return 1 if (args.strict and new) else 0


if __name__ == "__main__":
    sys.exit(main())
