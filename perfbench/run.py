"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
and a traffic mix; ``perfbench/lib/bench.py`` says what a run does.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from the program's spans and a
device trace of one more period of the churn.

Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced) and,
last, ``checks``: each number compared with its limit.  The line before it
holds the set-up's parts.  The numbers compared are also the last lines of
standard error.  Without a card, with fewer cards than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, the run
prints no result and exits with 2 or 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the names whose modules may not be loaded in a run, compared with each
#: loaded module's top-level name (the part before the first dot) whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)}
                  & set(FORBIDDEN))


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))

    import torch

    from perfbench.lib import registry

    cell = registry.cell(args.workload, ROOT)
    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell {cell.name} needs {chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)

    from perfbench.lib import bench

    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of {found} were loaded in the run",
              file=sys.stderr)
        return 3

    ctx = out["ctx"]
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_module(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device}
    if args.trace:
        device["busy_s"] = out["trace"].busy_s
        device["window_s"] = out["trace"].host_s
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    info = {"setup": out["setup"], "window_s": out["window_s"],
            "steps": out["steps"],
            "failures_in_window": out["failures_in_window"],
            "left_out_of_update_gap": out["left_out"],
            "not_compared": out["not_compared"],
            "ms_per_step_by_window": out["ms_per_step_by_window"],
            "capture_kept_cache": out["capture_kept_cache"]}
    if args.trace:
        info["device_s_by_family"] = out["families"]
    print(json.dumps(info))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
