"""Replay a recorded spot-preemption trace through the tiny paper model on
the PyTorch port and compare recovery strategies on simulated wall-clock.

The counterpart of ``examples/spot_trace_demo.py``.  Every strategy sees
the *same* replayed cluster (same preemption times, same node costs), so
the wall-clock table isolates the policy: CheckFree absorbs each preemption
for ~30 s of stage reinit, checkpointing pays rollback + restore,
redundancy pays 1.654x on every iteration.  On the card by default;
``--device cpu`` runs the kernels' plain versions.

    PYTHONPATH=src python examples/torch_spot_trace_demo.py
    PYTHONPATH=src python examples/torch_spot_trace_demo.py \\
        --trace my_cluster.jsonl --strategies checkfree,adaptive

The default trace is the port's packaged
``repro_torch/sim/traces/spot_demo.jsonl`` (~36 h of churn with two reclaim
storms).
"""
import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.trainer import Trainer
from repro_torch.core.walltime import WallClockModel
from repro_torch.data.pipeline import SyntheticLM, batch_for, make_batches
from repro_torch.models.model import Model
from repro_torch.recovery import available_strategies, default_protect_edges
from repro_torch.sim import get_scenario, simulate

DEFAULT_STRATEGIES = ["checkfree", "checkfree_plus", "checkpoint",
                      "redundant", "adaptive"]
STAGES, SEQ, BATCH = 4, 64, 8


def run(strategy: str, cfg, scenario, steps: int, device: str, work: str,
        params=None):
    protect = default_protect_edges(strategy)
    rcfg = RecoveryConfig(strategy=strategy, num_stages=STAGES,
                          protect_edge_stages=protect,
                          checkpoint_dir=os.path.join(work, "ckpt"),
                          store_dir=os.path.join(work, "store"))
    tcfg = TrainConfig(global_batch=BATCH, microbatch=BATCH, seq_len=SEQ,
                       steps=steps, eval_every=max(steps // 6, 1),
                       optimizer=OptimizerConfig(lr=6e-4, total_steps=steps),
                       recovery=rcfg)
    wall = WallClockModel(model_bytes=8 * cfg.param_count())
    schedule = simulate(scenario, steps=steps * 10, seed=42,
                        num_stages=STAGES, protect_edges=protect, wall=wall)
    src = SyntheticLM(cfg.vocab_size, seed=1234)
    rng = np.random.default_rng(999)
    evals = [batch_for(cfg, src.sample(rng, BATCH, SEQ)) for _ in range(2)]
    trainer = Trainer(Model(cfg, device=device, weights=False), tcfg,
                      wall=wall, schedule=schedule)
    state, hist = trainer.run(
        make_batches(cfg, batch=BATCH, seq=SEQ, seed=0, source=src), evals,
        params=None if params is None else TR.clone(params))
    return hist, schedule


def main(argv: Optional[Sequence[str]] = None, params=None) -> dict:
    """Replay the trace; ``params`` (a tree of tensors, e.g. JAX's
    ``model.init(PRNGKey(0))`` through ``repro_torch.convert``) replaces
    each run's seeded draw.  Returns what it printed, with each strategy's
    History and schedule."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="spot_demo.jsonl",
                    help="trace file (bare names resolve to the packaged "
                         "repro_torch/sim/traces/ directory)")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--strategies", default=",".join(DEFAULT_STRATEGIES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_spot_trace_demo: no CUDA device; pass "
                           "--device cpu to run on the CPU")

    strategies = [s for s in args.strategies.split(",") if s]
    unknown = set(strategies) - set(available_strategies())
    assert not unknown, f"unknown strategies {sorted(unknown)}; " \
                        f"available: {available_strategies()}"

    scenario = get_scenario(f"trace:{args.trace}",
                            iteration_time_s=300.0, num_stages=STAGES)
    cfg = get_config("paper-llama-124m").replace(
        name="paper-llama-124m-mini", num_layers=8, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=344, vocab_size=512,
        max_seq_len=64, dtype="float32")
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.0f}M params, "
          f"{STAGES} stages, {args.steps} steps\n"
          f"replaying trace {args.trace!r}\n")

    rows, hists, schedules = [], {}, {}
    # the checkpoint and store directories of the runs, removed at the end
    with tempfile.TemporaryDirectory(prefix="repro_torch_example_") as work:
        for strategy in strategies:
            hist, schedule = run(strategy, cfg, scenario, args.steps,
                                 args.device, os.path.join(work, strategy),
                                 params)
            hists[strategy], schedules[strategy] = hist, schedule
            best = min(e for _, _, e in hist.eval_loss) if hist.eval_loss \
                else float("nan")
            rows.append((strategy, len(hist.failures), hist.wall_iters,
                         hist.loss[-1], best, hist.wall_time[-1] / 3600,
                         hist.truncated))
            print(f"{strategy:16s} preemptions={rows[-1][1]} "
                  f"wall_iters={rows[-1][2]} final={rows[-1][3]:.4f} "
                  f"best_eval={rows[-1][4]:.4f} wall={rows[-1][5]:.1f}h"
                  f"{'  [TRUNCATED]' if rows[-1][6] else ''}")

    print("\nper-strategy wall-clock through the replayed trace:")
    for name, *_, wall_h, truncated in sorted(rows, key=lambda r: r[-2]):
        print(f"  {name:16s} {wall_h:7.1f}h"
              f"{'  [TRUNCATED]' if truncated else ''}")
    return {"rows": rows, "hists": hists, "schedules": schedules}


if __name__ == "__main__":
    main()
