"""The readings that a cell's limits are set from, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds a,b,... \
        [--control-seeds c,d,e] [--out readings.json]

For each seed of ``--seeds``: the program's checked steps (as a run of the
cell makes them, through ``Trainer.run`` at the cell's own batch and
sequence), the plain float32 reference over them, and the four gaps: the
lower readings.  For each seed of ``--control-seeds`` also the control,
the reference computed with every product's operands in float8 (the
precision below the configuration's bfloat16), and two faults planted in
the reference: half of each batch left out (the mean over the rest) and
one tower leaf's gradient doubled where it is produced.  A state left
unchanged reads 1 on ``update_gap`` by the measure and needs no run.

Writes one JSON object with every reading and the summary: the largest
program gap and the least control and fault gaps, by number.  Needs a card;
the benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def program_side(cell, seed: int, device):
    """The program's first step and checked steps for ``seed``; the check
    schedule and batches."""
    from perfbench.lib import program as P
    from perfbench.lib import traffic as TF
    prog = P.Program(cell.conf, cell.mix, cell.fam, seed, device)
    first = prog.first_step()
    chk = cell.mix["check"]
    sched = TF.check_schedule(chk["failures"], prog.stages, seed)
    checked = prog.checked_steps(sched, int(chk["steps"]))
    batches = prog.stream.batches(0, int(chk["steps"]))
    stages = prog.stages
    prog.close()
    return first, checked, sched, batches, stages


def as_program(followed):
    """A reference pass in the program's place: its first step and checked
    steps in the program's form."""
    first = {"loss": followed.losses[0], "grad": followed.first_grad,
             "omegas": followed.first_omegas}
    return first, {"losses": followed.losses, "moved": followed.moved}


def readings(cell, seeds, controls, device, log=lambda **kw: None) -> dict:
    """Every reading of ``seeds`` (the program) and ``controls`` (the
    control and the planted faults) for ``cell`` on ``device``."""
    import math

    from perfbench.lib import bench as B
    from perfbench.lib import check as CK
    from perfbench.lib import reftrain as R

    fam = cell.fam
    tower = [(p[1:], math.prod(shape)) for p, shape, _ in
             fam.leaf_specs(cell.conf) if p[0] == fam.TOWER]
    doubled = max(tower, key=lambda t: t[1])[0]

    def double(grads):
        R.get_path(grads[fam.TOWER], doubled).mul_(2.0)

    report = {"program": {}, "control": {}, "half_batch": {},
              "grad_doubled": {}, "seconds": {},
              "doubled_leaf": ".".join(doubled)}
    for seed in sorted(set(seeds) | set(controls)):
        t0 = time.perf_counter()
        first, checked, sched, batches, stages = program_side(cell, seed,
                                                              device)
        t1 = time.perf_counter()
        ref = B.follow_reference(cell, seed, device, batches, sched.by_wall,
                                 stages)
        t2 = time.perf_counter()
        report["seconds"][seed] = {"program": t1 - t0, "reference": t2 - t1}
        if seed in seeds:
            report["program"][seed] = CK.numbers(first, checked, ref)
            log(seed=seed, program=report["program"][seed],
                left_out=CK.left_out(ref), seconds=report["seconds"][seed])
        if seed not in controls:
            continue
        ctrl = B.follow_reference(cell, seed, device, batches, sched.by_wall,
                                  stages, ops=R.fp8_ops())
        report["control"][seed] = CK.numbers(*as_program(ctrl), ref)
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()}
                for b in batches]
        fault = B.follow_reference(cell, seed, device, half, sched.by_wall,
                                   stages)
        report["half_batch"][seed] = CK.numbers(*as_program(fault), ref)
        fault = B.follow_reference(cell, seed, device, batches, sched.by_wall,
                                   stages, grad_hook=double)
        report["grad_doubled"][seed] = CK.numbers(*as_program(fault), ref)
        log(seed=seed, control=report["control"][seed],
            half_batch=report["half_batch"][seed],
            grad_doubled=report["grad_doubled"][seed])
    summary = {}
    for kind in ("program", "control", "half_batch", "grad_doubled"):
        rows = report[kind]
        if rows:
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(r[k] for r in rows.values())
                             for k in CK.NUMBERS}
    report["summary"] = summary
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from perfbench.lib import program as P
    from perfbench.lib import registry

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload, ROOT)
    P.build_kernels()

    def log(**kw):
        print(json.dumps(kw), flush=True)

    report = readings(cell, _ints(args.seeds), _ints(args.control_seeds),
                      torch.device("cuda"), log)
    report["workload"] = cell.name
    report["card"] = torch.cuda.get_device_name(0)
    report["total_s"] = time.perf_counter() - T_START
    log(summary=report["summary"], total_s=report["total_s"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
