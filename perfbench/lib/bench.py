"""One run of one cell: set-up, the timed window, the per-layer readings of
a traced run, then the check against the plain reference.

Set-up (everything before the first timed step, ``setup_s``):

1. the port's CUDA libraries, built into the checkout's ``build/`` once;
2. the trainer and the weights, drawn on the device from the seed;
3. the checked steps, through ``Trainer.run`` on the cell's own batch and
   sequence: one step from the seed's weights (the gradient as Adam got
   it), then the mix's checked steps from the same weights again with its
   checked failures (losses, each leaf's change); they also build every
   kernel and, in fused windows, capture the CUDA graph;
4. one period of the mix's churn, through ``Trainer.run``: every recovery
   and window size the window will dispatch, and the time a period takes.

The window is one ``Trainer.run`` of whole periods of the churn, as many as
``--seconds`` holds at the warm-up's pace (at least one), on batches no
earlier run saw.  Its clock runs from the start of the first
``window_dispatch`` span to the end of the call; ``Trainer.run``'s own
set-up before that span is not in it.

A traced run then profiles one more period and reads the per-layer
metrics.  Once the window has closed and the peaks are read, the program's
state is freed and the plain reference follows the checked steps from the
seed's weights (float32, TF32 off); ``correct`` says whether every gap is
within the cell's limit.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional

import torch

from perfbench.lib import check as CK
from perfbench.lib import device_trace as DT
from perfbench.lib import reftrain as R
from perfbench.lib import traffic as TF
from perfbench.lib.registry import Cell


@dataclasses.dataclass
class Ctx:
    """What a per-layer metric's reader may read."""
    conf: dict
    mix: dict
    fam: Any
    halves: int
    window_s: float
    window_steps: int
    window_spans: List[dict]
    trace: Optional[DT.Trace]
    traced_spans: List[dict]        # the program's spans of the traced steps
    origin: float                   # host clock at the spans' origin
    profiled_steps: int
    peak_reserved_bytes: int
    param_numel: int


def follow_reference(cell: Cell, seed: int, device, batches,
                     failures: Dict[int, List[int]], stages: int,
                     ops: R.Ops = R.FP32, grad_hook=None) -> R.Followed:
    """The plain reference over the checked steps from the seed's weights,
    with each leaf's change (``moved``) added."""
    fam, conf, mix = cell.fam, cell.conf, cell.mix
    R.strict_fp32()
    params = R.make_params(fam, conf, seed, device)
    strategy = {"stages": stages, "swap": bool(mix["swap"]), **mix["recovery"]}
    ref = R.follow(fam, conf, params, batches, failures, strategy=strategy,
                   optim=R.Optim.of(mix["optimizer"]), ops=ops, device=device,
                   grad_hook=grad_hook)
    moved = {}
    with torch.no_grad():
        for path, leaf in R.leaves_with_path(ref.params):
            start = R.make_leaf(fam, conf, path, seed, device)
            moved[R.name(path)] = float((leaf - start).double().norm())
            del start
    ref.moved = moved
    ref.params = None
    return ref


def per_window_ms(spans: List[dict]) -> Dict[str, float]:
    """Host ms a step of each window, from its dispatch's start to its
    drain's end: the least, the median and the most."""
    starts = [s for s in spans if s["name"] == "window_dispatch"]
    ends = [s for s in spans if s["name"] == "window_drain"]
    per = sorted((e["ts_us"] + e["dur_us"] - d["ts_us"]) / 1e3
                 / int(d["args"]["k"]) for d, e in zip(starts, ends))
    if not per:
        return {}
    return {"min": per[0], "median": per[len(per) // 2], "max": per[-1]}


def _cuda(device: torch.device) -> bool:
    return device.type == "cuda"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict[str, Any]:
    """One run; returns the result's fields and ``setup`` (the set-up's
    parts, seconds) and ``checks`` ({name: {value, limit}})."""
    from perfbench.lib import program as P

    device = torch.device(device)
    mix, conf = cell.mix, cell.conf
    parts: Dict[str, float] = {}
    mark = [time.perf_counter()]
    parts["import_s"] = mark[0] - t_start

    def lap(name: str) -> None:
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    if _cuda(device):
        torch.cuda.reset_peak_memory_stats(device)
        P.build_kernels()
    lap("build_s")
    prog = P.Program(conf, mix, cell.fam, seed, device)
    stages = prog.stages
    P.sync(device)
    lap("weights_s")
    first = prog.first_step()
    lap("first_step_s")
    chk = mix["check"]
    check_sched = TF.check_schedule(chk["failures"], stages, seed)
    checked = prog.checked_steps(check_sched, int(chk["steps"]))
    lap("checked_steps_s")
    churn = mix["churn"]
    period = int(churn["period"])
    start = int(chk["steps"])
    warm = prog.run(period, TF.churn_schedule(churn, stages, period, seed),
                    start)
    warm_s = warm.seconds
    del warm
    start += period
    lap("warmup_s")
    periods = max(1, math.ceil(seconds / warm_s))
    steps = periods * period
    schedule = TF.churn_schedule(churn, stages, steps, seed)
    prog.stream.batches(start, steps)          # drawn before the clock
    lap("window_batches_s")

    win = prog.run(steps, schedule, start)
    t_first = prog.origin + P.first_dispatch(win.spans)["ts_us"] / 1e6
    window_s = win.t_end - t_first
    setup_s = t_first - t_start
    parts["trainer_run_setup_s"] = t_first - win.t_begin
    tokens = mix["batch"] * mix["seq"]
    peak = torch.cuda.max_memory_allocated(device) if _cuda(device) else 0
    reserved = torch.cuda.max_memory_reserved(device) if _cuda(device) else 0
    window_spans = win.spans
    del win
    kept_cache = getattr(prog.trainer.window, "kept_cache", None)

    traced: Optional[DT.Trace] = None
    traced_spans: List[dict] = []
    if trace:
        sched = TF.churn_schedule(churn, stages, period, seed)
        prog.stream.batches(start + steps, period)
        first_span = len(prog.recorder.spans)
        traced = DT.profile(lambda: prog.run(period, sched, start + steps),
                            device)
        traced_spans = prog.recorder.spans[first_span:]
    origin = prog.origin
    numel = sum(t.numel() for _, t in R.leaves_with_path(prog.params))
    check_batches = prog.stream.batches(0, int(chk["steps"]))
    prog.close()
    del prog

    ref = follow_reference(cell, seed, device, check_batches,
                           check_sched.by_wall, stages)
    values = CK.numbers(first, checked, ref)
    correct, table = CK.judge(values, cell.limits["limits"])

    halves = 2 if mix["swap"] else 1
    ctx = Ctx(conf=conf, mix=mix, fam=cell.fam, halves=halves,
              window_s=window_s, window_steps=steps,
              window_spans=window_spans, trace=traced,
              traced_spans=traced_spans, origin=origin,
              profiled_steps=period if trace else 0,
              peak_reserved_bytes=reserved, param_numel=numel)
    out: Dict[str, Any] = {
        "correct": correct, "attempted": steps, "failed": 0,
        "setup": parts, "checks": table, "ctx": ctx,
        "not_compared": {k: v for k, v in values.items() if k not in table},
        "left_out": CK.left_out(ref),
        "failures_in_window": len(schedule),
        "e2e": {"train_tokens_per_s": steps * tokens / window_s,
                "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        "peak_bytes": peak, "window_s": window_s, "steps": steps,
        "ms_per_step_by_window": per_window_ms(window_spans),
        "capture_kept_cache": kept_cache}
    if traced is not None:
        out["trace"] = traced
        out["families"] = DT.family_seconds(traced)
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in DT.top_ops(traced)],
            "idle_gaps": [[n, s] for n, s in
                          traced.gaps(traced_spans, origin)]}
    return out
