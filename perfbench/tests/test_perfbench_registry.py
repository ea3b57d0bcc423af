"""A new configuration, traffic mix, cell and per-layer metric are files
found by name: a throwaway set of them in a temporary checkout runs with no
edit to a file that is there."""
import json
import shutil
import time

from perfbench.tests import _tiny
from perfbench.lib import bench, registry

METRIC = '''
def read(ctx):
    return float(ctx.window_steps) if ctx.window_steps else None
'''


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    for sub in ("configs", "traffic", "cells", "metrics", "reference"):
        (root / "perfbench" / sub).mkdir(parents=True)
    # a family of its own name: the dense reference under another name
    shutil.copy(_tiny.ROOT / "perfbench" / "reference" / "dense.py",
                root / "perfbench" / "reference" / "throwaway_family.py")
    conf = _tiny.conf("dense", "float32")
    conf["family"] = "throwaway_family"
    (root / "perfbench" / "configs" / "thr.json").write_text(json.dumps(conf))
    mix = _tiny.mix("dense", batch=2, seq=16)
    mix["churn"] = {"pattern": "cadence", "period": 4, "offset": 2,
                    "stages": "interior"}
    (root / "perfbench" / "traffic" / "thr.mix.json").write_text(
        json.dumps(mix))
    (root / "perfbench" / "cells" / "thr.cell.json").write_text(
        json.dumps(_tiny.limits(1e-4)))
    (root / "perfbench" / "metrics" / "steps_seen.py").write_text(METRIC)
    bench_json = {
        "command": ["python3", "perfbench/run.py"], "paths": ["perfbench"],
        "run_seconds": 1,
        "configs": [{"name": "thr", "source": "https://example.org",
                     "file": "perfbench/configs/thr.json", "reduced": [],
                     "why": "a test"}],
        "workloads": [{"name": "thr.cell", "config": "thr",
                       "traffic": "thr.mix", "chips": 1, "why": "a test"}],
        "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower",
                        "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "steps_seen", "unit": "steps",
                       "better": "higher", "source": "host_clock",
                       "layer": "test", "moves": "setup_s",
                       "workloads": ["thr.cell"]}]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return root


def test_a_new_cell_is_found_by_name_and_runs(tmp_path):
    root = _checkout(tmp_path)
    cell = registry.cell("thr.cell", root)
    assert cell.conf["family"] == "throwaway_family"
    assert cell.fam.__name__.endswith("throwaway_family")
    assert cell.mix["churn"]["period"] == 4
    assert [m["name"] for m in cell.per_layer] == ["steps_seen"]
    out = bench.run_cell(cell, 2 ** 32 + 9, 0.01, False, "cpu",
                         time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["steps"] == 4 and out["failures_in_window"] == 1
    assert cell.metric_module("steps_seen").read(out["ctx"]) == 4.0


def test_the_benchmarks_cells_resolve():
    bench_json = registry.load_json(registry.ROOT / "BENCHMARK.json")
    for w in bench_json["workloads"]:
        cell = registry.cell(w["name"])
        for m in cell.per_layer:
            assert callable(cell.metric_module(m["name"]).read)
        # a number a cell does not compare is named, with its reason
        assert set(cell.limits["limits"]) | set(
            cell.limits.get("not_compared", {})) == set(_tiny.NUMBERS)
