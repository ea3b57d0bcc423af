"""Baseline file support, the port's copy of ``repro.analysis.baseline``:
grandfather existing findings, fail on new ones.

The baseline is a JSON file mapping finding fingerprints (content hashes of
``rule:file:line-text``) to a human-readable record.  Workflow:

* ``python -m repro_torch.analysis src/repro_torch --write-baseline``
  snapshots the current findings into
  ``.repro-torch-analysis-baseline.json`` (a file of the port's own, apart
  from the JAX package's);
* subsequent ``--strict`` runs fail only on findings whose fingerprint is
  absent from the baseline — fixing a line (or the finding) invalidates its
  fingerprint, so the baseline monotonically shrinks.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from repro_torch.analysis.engine import Finding

DEFAULT_BASELINE = ".repro-torch-analysis-baseline.json"


def load_baseline(path: str) -> Dict[str, Dict]:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("findings", data) if isinstance(data, dict) else {}
    return dict(entries)


def write_baseline(path: str, findings: List[Finding]) -> None:
    entries = {
        f.fingerprint: {"rule": f.rule, "path": f.path, "line": f.line,
                        "message": f.message}
        for f in findings}
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": entries}, f, indent=1,
                  sort_keys=True)
        f.write("\n")


def split_by_baseline(findings: List[Finding], baseline: Dict[str, Dict],
                      ) -> Tuple[List[Finding], List[Finding]]:
    """-> (new_findings, baselined_findings)."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if f.fingerprint in baseline else new).append(f)
    return new, old
