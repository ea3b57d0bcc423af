"""Finds everything of a cell by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix.  The configuration's
file is the ``file`` of its entry; its ``family`` names the plain reference
``perfbench/reference/<family>.py``.  The mix is ``perfbench/traffic/<mix>
.json``, the cell's limits ``perfbench/cells/<workload>.json`` and each
per-layer metric ``perfbench/metrics/<metric>.py`` (a ``read(ctx)`` that
returns a number, or None where it finds nothing to read).  Adding a cell,
a mix, a configuration or a metric adds files and entries; no file here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, List, Optional

#: the checkout's root: the directory that holds BENCHMARK.json
ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name`` (loaded once)."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Cell:
    """One workload of the benchmark with everything it names."""
    name: str
    workload: dict
    conf: dict                      # the configuration file
    mix: dict                       # the traffic mix
    limits: dict                    # the cell's file: limits and readings
    fam: Any                        # the family's plain reference module
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def metric_module(self, name: str):
        return metric_module(self.root, name)


def metric_module(root: Path, name: str):
    return _module(root / "perfbench" / "metrics" / f"{name}.py",
                   f"perfbench_metric_{_ident(name)}")


def reference_module(root: Path, family: str):
    return _module(root / "perfbench" / "reference" / f"{family}.py",
                   f"perfbench.reference.{_ident(family)}")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Optional[Path] = None,
         bench: Optional[dict] = None) -> Cell:
    root = ROOT if root is None else Path(root)
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{sorted(entries)}")
    w = entries[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    conf = load_json(root / entry["file"])
    mix = load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "perfbench" / "cells" / f"{workload}.json")
    return Cell(
        name=workload, workload=w, conf=conf,
        mix=mix, limits=limits, fam=reference_module(root, conf["family"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root)


def cell_from_files(name: str, conf: dict, mix: dict, limits: dict,
                    root: Optional[Path] = None) -> Cell:
    """A cell made of given dicts (tests at small sizes), with no metric."""
    root = ROOT if root is None else Path(root)
    return Cell(name=name, workload={"name": name, "chips": 1},
                conf=conf, mix=mix, limits=limits,
                fam=reference_module(root, conf["family"]), end_to_end=[],
                per_layer=[], root=root)
