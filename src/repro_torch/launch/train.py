"""End-to-end training driver of the port, with CheckFree recovery.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch paper-llama-124m --strategy checkfree_plus \
        --steps 300 --rate 0.10 [--reduced] [--seq 512 --batch 8] \
        [--device cpu] [--fuse-window 8] [--out history.json] \
        [--telemetry-dir runs/x [--trace]]
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --layers 6 \
        --stages 4 --strategy elastic --scenario spot_shrink --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --reduced --device cpu --strategy checkfree_plus
    PYTHONPATH=src python -m repro_torch.launch.train --backend spmd \
        --reduced --layers 4 --stages 2 --device cpu --strategy checkfree_plus

Every family the port trains goes through it: the dense decoders, mamba2-1.3b
(ssm) and zamba2-2.7b (hybrid).

The counterpart of ``repro.launch.train`` for the flags this slice supports:
config -> model -> data -> failure schedule -> Trainer (recovery strategy),
then the History.  ``--fuse-window`` (8, as in JAX) runs up to that
many steps as one window, a replayed CUDA graph on the card; 1 steps
eagerly.  ``--strategy`` takes every registered policy:
the CheckFree family, ``redundant``, the ``checkpoint`` baseline, the
state-store baselines ``tiered_ckpt`` and ``neighbor`` and ``adaptive``.
Their checkpoint and store directories lie in a directory of this run's own
under the temporary directory (``TMPDIR``), removed when the run ends: each
strategy wipes its directory when it starts, so a fixed path would let two
runs on one machine delete each other's state.
``--scenario`` (a registered scenario of :mod:`repro_torch.sim` or
``trace:<file>``) replaces ``--rate``'s Bernoulli schedule with a simulated
cluster; ``--depart-prob`` and ``--regrow-h`` override its permanent
departures and the hours until fresh capacity arrives, and need
``--scenario``.  ``--strategy elastic`` shrinks the pipeline on a departure
and grows it back on a regrow.  ``--device`` defaults to ``cuda`` and raises
where there is none.  ``--telemetry-dir`` records the run's structured
events into ``events.jsonl`` there (the recorder is installed before the
schedule is simulated, so the simulator's events are in the stream; read
the run with ``python -m repro_torch.telemetry.report DIR``), and
``--trace`` also writes a Chrome trace (``trace.json``) there; the recorder
is closed and uninstalled when the run ends, also when it raises.
``--backend spmd`` trains the dense and MoE families as a pipeline: one rank
a stage (``launch.mesh.spawn_stages``; the stages snapped to a divisor of
the layers, as in JAX), every rank on the card (or the CPU with ``--device
cpu``), gloo between them, with every strategy.  Rank 0 alone logs,
records the telemetry and writes ``--out``; its History is the run's.  The
ranks share one run directory, made and removed by the launching process,
and each strategy keeps every rank's checkpoints and stores in a directory
of that rank's own under it.  The backend's refusals (another family, a
sliding window, a layer count the stages do not divide) are made here,
before any rank starts or any run directory is made.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
from repro_torch.configs import ARCHS, PAPER_MODELS, get_config, get_stages, reduced
from repro_torch.core.failures import FailureSchedule
from repro_torch.core.state import History
from repro_torch.core.trainer import Trainer
from repro_torch.core.walltime import WallClockModel
from repro_torch.data.pipeline import SyntheticLM, batch_for, make_batches
from repro_torch.launch.mesh import spawn_stages
from repro_torch.models.model import build_model
from repro_torch.recovery import available_strategies, default_protect_edges
from repro_torch.sim import get_scenario, simulate
from repro_torch.telemetry import log, set_verbosity


def main(argv: Optional[Sequence[str]] = None) -> History:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-llama-124m",
                    choices=sorted(ARCHS) + sorted(PAPER_MODELS))
    ap.add_argument("--strategy", default="checkfree",
                    choices=available_strategies())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rate", type=float, default=0.10,
                    help="hourly per-stage failure probability")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=0,
                    help="0 -> the config's max_seq_len (capped at 512)")
    ap.add_argument("--lr", type=float, default=0.0, help="0 -> 3e-4")
    ap.add_argument("--stages", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the same family")
    ap.add_argument("--layers", type=int, default=0,
                    help="override the config's transformer layer count "
                         "(0 = keep)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--out", default="", help="write History JSON here")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--fuse-window", type=int, default=8,
                    help="max steps fused into one window (1 = eager)")
    ap.add_argument("--scenario", default="",
                    help="simulated-cluster environment (repro_torch.sim): a "
                         "registered scenario name or trace:<file>; "
                         "supersedes --rate's Bernoulli schedule")
    ap.add_argument("--depart-prob", type=float, default=None,
                    help="override the scenario's per-failure probability "
                         "that the node is gone for good")
    ap.add_argument("--regrow-h", type=float, default=None,
                    help="override the scenario's hours until fresh "
                         "capacity replaces a departed node (inf = never)")
    ap.add_argument("--telemetry-dir", default="",
                    help="record the structured telemetry event stream "
                         "(events.jsonl) into this directory; summarize "
                         "with `python -m repro_torch.telemetry.report "
                         "<dir>`")
    ap.add_argument("--trace", action="store_true",
                    help="also export a Chrome trace_event JSON "
                         "(trace.json, loadable in Perfetto) into "
                         "--telemetry-dir")
    ap.add_argument("--backend", default="host", choices=["host", "spmd"],
                    help="'spmd' runs the pipeline-parallel backend: one "
                         "process per stage, gloo between them")
    args = ap.parse_args(argv)
    if args.trace and not args.telemetry_dir:
        ap.error("--trace needs --telemetry-dir")
    if (args.depart_prob is not None or args.regrow_h is not None) \
            and not args.scenario:
        ap.error("--depart-prob/--regrow-h need --scenario (repro_torch.sim)")
    if args.backend == "spmd":
        from repro_torch.pipeline.spmd import refusal
        cfg, stages = _model_and_stages(args)
        why = refusal(cfg, stages)
        if why:
            ap.error(f"--backend spmd: {why}")
        _device(args)
        run_dir = tempfile.mkdtemp(prefix="repro_torch_train_")
        try:
            # one rank a stage; rank 0's History is the run's
            return spawn_stages(_spmd_rank, stages, args, run_dir,
                                cuda=args.device.startswith("cuda"),
                                timeout_s=None)[0]
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
    return _run(args)


def _spmd_rank(rank: int, args: argparse.Namespace, run_dir: str) -> History:
    """One rank of ``--backend spmd`` in the group's ``run_dir``: rank 0
    logs, records and writes ``--out``; the others run silent."""
    if rank:
        set_verbosity(-1)
        args = argparse.Namespace(**{**vars(args), "out": "",
                                     "telemetry_dir": "", "trace": False})
    return _run(args, run_dir)


def _run(args: argparse.Namespace, run_dir: Optional[str] = None) -> History:
    """The run, with the telemetry recorder of ``--telemetry-dir``."""
    rec = (telemetry.configure(run_dir=args.telemetry_dir)
           if args.telemetry_dir else None)
    try:
        hist = _train(args, run_dir)
        if rec is not None and args.trace:
            log(f"trace -> {rec.write_chrome_trace()}")
    finally:
        # a run that raises leaves no recorder installed either
        if rec is not None:
            rec.close()
            telemetry.set_recorder(None)
    if rec is not None:
        log(f"telemetry -> {os.path.join(args.telemetry_dir, 'events.jsonl')}"
            f"  (summarize: python -m repro_torch.telemetry.report "
            f"{args.telemetry_dir})")
    return hist


def _device(args: argparse.Namespace) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device; pass --device cpu "
                           "to train on the CPU with the kernels' plain "
                           "versions")
    return device


def _model_and_stages(args: argparse.Namespace):
    """(config, stages) of the arguments; on the spmd backend the stages
    snapped to a divisor of the layers (``repro/launch/train.py:106-116``)."""
    cfg = get_config(args.arch)
    stages = args.stages or get_stages(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        stages = min(stages, 2)
    if args.layers > 0:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
        stages = args.stages or stages
    stages = min(max(stages, 1), cfg.num_layers)
    if args.backend == "spmd" and cfg.num_layers % stages:
        stages = max(d for d in range(1, stages + 1)
                     if cfg.num_layers % d == 0)
    return cfg, stages


def _train(args: argparse.Namespace, run_dir: Optional[str] = None
           ) -> History:
    """The run of ``main``'s parsed and checked arguments; its checkpoints
    and stores go under ``run_dir`` (default: a directory of the run's own,
    removed at the end)."""
    device = _device(args)
    cfg, stages = _model_and_stages(args)
    seq = args.seq or min(cfg.max_seq_len, 512)
    lr = args.lr or 3e-4

    protect = default_protect_edges(args.strategy)
    rcfg = RecoveryConfig(
        strategy=args.strategy, num_stages=stages,
        failure_rate_per_hour=args.rate, scenario=args.scenario,
        seed=args.seed, protect_edge_stages=protect)
    tcfg = TrainConfig(
        global_batch=args.batch, microbatch=args.batch, seq_len=seq,
        steps=args.steps, eval_every=max(args.steps // 10, 1),
        fuse_window=args.fuse_window, seed=args.seed,
        optimizer=OptimizerConfig(lr=lr, total_steps=args.steps),
        recovery=rcfg)

    model = build_model(cfg, device=device, weights=False)
    n = cfg.param_count()
    log(f"arch={cfg.name} ({n / 1e6:.0f}M params) strategy={args.strategy} "
        f"backend={args.backend} device={device} stages={stages} "
        f"steps={args.steps} "
        f"rate={args.rate:.0%}/h seq={seq} batch={args.batch}")

    wall = WallClockModel(model_bytes=4 * n * 2)
    schedule = None
    if args.scenario:
        # the Trainer's own schedule for rcfg.scenario, with the shrink
        # knobs' overrides
        overrides = {"depart_prob": args.depart_prob,
                     "regrow_h": args.regrow_h}
        schedule = simulate(
            get_scenario(args.scenario, **{k: v for k, v in overrides.items()
                                           if v is not None}),
            steps=args.steps * 10, seed=args.seed, num_stages=stages,
            protect_edges=rcfg.protect_edge_stages, wall=wall)
        log(schedule.summary())
    elif args.rate > 0 and args.strategy != "none":
        schedule = FailureSchedule(
            rate_per_hour=args.rate, iteration_time_s=rcfg.iteration_time_s,
            num_stages=stages, steps=args.steps * 10, seed=args.seed,
            protect_edges=rcfg.protect_edge_stages)
        log(schedule.summary())

    src = SyntheticLM(cfg.vocab_size, seed=1234)
    batches = make_batches(cfg, batch=args.batch, seq=seq, seed=args.seed,
                           source=src)
    rng = np.random.default_rng(999)
    evals = [batch_for(cfg, src.sample(rng, args.batch, seq), rng)
             for _ in range(2)]

    own = run_dir is None
    run_dir = tempfile.mkdtemp(prefix="repro_torch_train_") if own else run_dir
    try:
        tcfg = dataclasses.replace(tcfg, recovery=dataclasses.replace(
            rcfg, checkpoint_dir=os.path.join(run_dir, "ckpt"),
            store_dir=os.path.join(run_dir, "statestore")))
        trainer = Trainer(model, tcfg, wall=wall, schedule=schedule,
                          backend=args.backend)
        state, hist = trainer.run(batches, evals, verbose=not args.quiet)
    finally:
        if own:
            shutil.rmtree(run_dir, ignore_errors=True)

    log(f"\ndone: {state.effective_step} effective steps over "
        f"{hist.wall_iters} wall iterations, "
        f"{len(hist.failures)} stage failures, final loss "
        f"{hist.loss[-1]:.4f}, modelled wall "
        f"{hist.wall_time[-1] / 3600:.1f}h", level=0)
    for (step, err) in hist.recovery_errors:
        log(f"  recovery @ wall-iter {step}: error term {err:.3e}")
    for (step, direction, k0, k1, moved, cost) in trainer.repartition_log:
        log(f"  {direction} @ wall-iter {step}: {k0} -> {k1} stages, "
            f"{moved} layers moved, {cost:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(hist.to_json())
        log(f"history -> {args.out}")
    return hist


if __name__ == "__main__":
    main()
