"""End-to-end driver on the PyTorch port: train the paper's 124M LLaMa
under stage churn with every recovery strategy, and compare
wall-clock-to-loss (the paper's Table 2 protocol).

The counterpart of ``examples/train_with_failures.py``.  On the card by
default (the hand-written kernels, fused windows replayed as CUDA graphs);
``--device cpu`` runs the kernels' plain versions.

Full scale (124M params, a few hundred steps):

    PYTHONPATH=src python examples/torch_train_with_failures.py --full

Default (CPU-sized model of the same family):

    PYTHONPATH=src python examples/torch_train_with_failures.py
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
from repro_torch.core.failures import FailureSchedule
from repro_torch.core.trainer import Trainer
from repro_torch.core.walltime import WallClockModel
from repro_torch.data.pipeline import SyntheticLM, batch_for, make_batches
from repro_torch.models.model import Model
from repro_torch.recovery import available_strategies, default_protect_edges

DEFAULT_STRATEGIES = ["checkfree", "checkfree_plus", "checkpoint",
                      "redundant"]


def run(strategy: str, cfg, stages: int, steps: int, rate: float,
        seq: int, batch: int, device: str, work: str, params=None):
    protect = default_protect_edges(strategy)
    rcfg = RecoveryConfig(strategy=strategy, num_stages=stages,
                          failure_rate_per_hour=rate,
                          protect_edge_stages=protect,
                          checkpoint_dir=os.path.join(work, "ckpt"),
                          store_dir=os.path.join(work, "store"))
    tcfg = TrainConfig(global_batch=batch, microbatch=batch, seq_len=seq,
                       steps=steps, eval_every=max(steps // 6, 1),
                       optimizer=OptimizerConfig(lr=6e-4, total_steps=steps),
                       recovery=rcfg)
    # schedule clock: 600 s/iter so a short run sees a paper-like failure
    # count (the paper's runs span days)
    schedule = FailureSchedule(
        rate_per_hour=rate, iteration_time_s=600.0,
        num_stages=stages, steps=steps * 10, seed=42,
        protect_edges=rcfg.protect_edge_stages)
    src = SyntheticLM(cfg.vocab_size, seed=1234)
    rng = np.random.default_rng(999)
    evals = [batch_for(cfg, src.sample(rng, batch, seq)) for _ in range(2)]
    trainer = Trainer(Model(cfg, device=device, weights=False), tcfg,
                      wall=WallClockModel(model_bytes=8 * cfg.param_count()),
                      schedule=schedule)
    state, hist = trainer.run(
        make_batches(cfg, batch=batch, seq=seq, seed=0, source=src), evals,
        params=None if params is None else TR.clone(params))
    return hist, schedule


def main(argv: Optional[Sequence[str]] = None, params=None) -> dict:
    """Train every strategy; ``params`` (a tree of tensors, e.g. JAX's
    ``model.init(PRNGKey(0))`` through ``repro_torch.convert``) replaces
    each run's seeded draw.  Returns what it printed, with each strategy's
    History and schedule."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the real 124M model (paper Table 4 small)")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--rate", type=float, default=0.10)
    ap.add_argument("--strategies", default=",".join(DEFAULT_STRATEGIES),
                    help="comma-separated registry names (see "
                         "repro_torch.recovery.available_strategies); e.g. "
                         "add 'adaptive' to compare the policy-switching "
                         "hybrid")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_train_with_failures: no CUDA device; pass "
                           "--device cpu to run on the CPU")

    strategies = [s for s in args.strategies.split(",") if s]
    unknown = set(strategies) - set(available_strategies())
    assert not unknown, f"unknown strategies {sorted(unknown)}; " \
                        f"available: {available_strategies()}"

    if args.full:
        cfg = get_config("paper-llama-124m")
        stages, seq, batch = 4, 512, 8
        steps = args.steps or 300
    else:
        cfg = get_config("paper-llama-124m").replace(
            name="paper-llama-124m-mini", num_layers=8, d_model=128,
            num_heads=4, num_kv_heads=4, d_ff=344, vocab_size=512,
            max_seq_len=64, dtype="float32")
        stages, seq, batch = 4, 64, 8
        steps = args.steps or 120

    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.0f}M params, "
          f"{stages} stages, {steps} steps, {args.rate:.0%}/h churn\n")

    rows, hists, schedules = [], {}, {}
    # the checkpoint and store directories of the runs, removed at the end
    with tempfile.TemporaryDirectory(prefix="repro_torch_example_") as work:
        for strategy in strategies:
            hist, schedule = run(strategy, cfg, stages, steps, args.rate,
                                 seq, batch, args.device,
                                 os.path.join(work, strategy), params)
            hists[strategy], schedules[strategy] = hist, schedule
            best = min(e for _, _, e in hist.eval_loss) if hist.eval_loss \
                else float("nan")
            rows.append((strategy, len(hist.failures), hist.wall_iters,
                         hist.loss[-1], best, hist.wall_time[-1] / 3600))
            print(f"{strategy:16s} failures={rows[-1][1]} "
                  f"wall_iters={rows[-1][2]} final={rows[-1][3]:.4f} "
                  f"best_eval={rows[-1][4]:.4f} wall={rows[-1][5]:.1f}h")

    print("\nwall-clock ordering (paper: CheckFree/+ < redundant < ckpt):")
    for name, *_, wall in sorted(rows, key=lambda r: r[-1]):
        print(f"  {name:16s} {wall:7.1f}h")
    return {"cfg": cfg, "rows": rows, "hists": hists,
            "schedules": schedules}


if __name__ == "__main__":
    main()
