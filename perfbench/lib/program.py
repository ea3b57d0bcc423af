"""The system under test: the port's trainer, driven through its normal
entry, ``repro_torch.core.trainer.Trainer.run``.

This is the one module of the benchmark that imports the program
(``repro_torch``).  It builds the port's configuration named by a
configuration file, a ``Trainer`` for the traffic mix's strategy, batch,
sequence and window, and runs it with the benchmark's weights, batches and
failure schedules.  The weights come in through ``init_params``, the
trainer's own hook for its starting parameters (``run(params=...)`` would
copy the whole tree to the host for restarts that the CheckFree strategies
never make); the trainer trains those tensors in place.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional

import torch

from perfbench.lib import reftrain as R
from perfbench.lib import traffic as TF

from repro_torch import telemetry
from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.trainer import Trainer
from repro_torch.kernels import build as KB
from repro_torch.models.model import build_model
from repro_torch.recovery import default_protect_edges


def port_config(conf: dict, fam):
    """The port's ModelConfig for a configuration file, checked against the
    file's published sizes (``fam.program_fields``)."""
    prog = conf["program"]
    cfg = get_config(prog["arch"])
    changes = {}
    for key, value in prog.get("replace", {}).items():
        old = getattr(cfg, key)
        # a nested group (ssm, moe) given as a dict of its changed fields
        changes[key] = (dataclasses.replace(old, **value)
                        if dataclasses.is_dataclass(old) else value)
    cfg = cfg.replace(**changes)
    have = dataclasses.asdict(cfg)
    wrong = []
    for key, want in fam.program_fields(conf).items():
        got = have[key]
        if isinstance(want, dict):
            bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
            if bad:
                wrong.append(f"{key} {bad}")
        elif got != want:
            wrong.append(f"{key}: the port has {got!r}, the file {want!r}")
    if wrong:
        raise ValueError(f"the port's {prog['arch']} does not run the file's "
                         f"configuration: {'; '.join(wrong)}")
    return cfg


def optimizer_config(mix: dict) -> OptimizerConfig:
    o = mix["optimizer"]
    return OptimizerConfig(lr=o["lr"], warmup_steps=o["warmup_steps"],
                           total_steps=o["total_steps"],
                           grad_clip=o["grad_clip"],
                           min_lr_ratio=o["min_lr_ratio"],
                           schedule="cosine")


class BenchTrainer(Trainer):
    """The port's Trainer, starting every run from the benchmark's weights
    (trained in place) instead of its own draw."""

    bench_params: Optional[Dict[str, Any]] = None

    def init_params(self):
        return self.bench_params


def build_kernels() -> Dict[str, Any]:
    """Every CUDA library of the port, built into the checkout's build
    directory unless it is there already (the first run of a checkout)."""
    return KB.build()


@dataclasses.dataclass
class RunRecord:
    seconds: float
    t_begin: float                  # host clock at the call and its end
    t_end: float
    losses: List[float]
    spans: List[dict]
    state: Any


class Program:
    """One trainer for a cell, its weights and its batches."""

    def __init__(self, conf: dict, mix: dict, fam, seed: int, device):
        self.conf, self.mix, self.fam = conf, mix, fam
        self.device = torch.device(device)
        self.seed = int(seed)
        self.cfg = port_config(conf, fam)
        self.stages = int(conf["program"]["stages"])
        strategy = mix["strategy"]
        rec = mix["recovery"]
        rcfg = RecoveryConfig(
            strategy=strategy, num_stages=self.stages,
            lr_boost=rec["lr_boost"], lr_boost_decay=rec["lr_boost_decay"],
            lr_boost_cap=rec["lr_boost_cap"], failure_rate_per_hour=0.0,
            seed=self.seed % (2 ** 31),
            protect_edge_stages=default_protect_edges(strategy))
        self.tcfg = TrainConfig(
            global_batch=mix["batch"], microbatch=mix["batch"],
            seq_len=mix["seq"], steps=1, eval_every=10 ** 9,
            fuse_window=mix["fuse_window"], seed=self.seed % (2 ** 31),
            optimizer=optimizer_config(mix), recovery=rcfg)
        model = build_model(self.cfg, device=self.device, weights=False)
        self.trainer = BenchTrainer(model, self.tcfg,
                                    schedule=TF.Schedule({}))
        self.params = R.make_params(fam, conf, self.seed, self.device)
        self.trainer.bench_params = self.params
        # ids of the configuration's vocabulary, never its padding rows
        self.stream = TF.TokenStream(conf["vocab_size"], mix["batch"],
                                     mix["seq"], self.seed)
        self.recorder = telemetry.Recorder()
        telemetry.set_recorder(self.recorder)
        #: the host clock (``time.perf_counter``) at the spans' origin
        self.origin = time.perf_counter() - self.recorder.now()

    # ---- runs -------------------------------------------------------------
    def run(self, steps: int, schedule: TF.Schedule,
            start: int) -> RunRecord:
        """``Trainer.run`` over ``steps`` steps on batches ``start ..``;
        the host seconds of the whole call, its losses and its spans."""
        t = self.trainer
        t.tcfg = dataclasses.replace(self.tcfg, steps=int(steps))
        t.schedule = schedule
        first = len(self.recorder.spans)
        sync(self.device)
        t0 = time.perf_counter()
        state, hist = t.run(TF.iterate(self.stream, start, steps))
        sync(self.device)
        seconds = time.perf_counter() - t0
        if hist.truncated or state.effective_step != steps:
            raise RuntimeError(f"the run trained {state.effective_step} of "
                               f"{steps} steps")
        return RunRecord(seconds, t0, t0 + seconds, list(hist.loss),
                         self.recorder.spans[first:], state)

    def reset_weights(self) -> None:
        """The weights of the seed again, drawn into the same tensors."""
        with torch.no_grad():
            for path, leaf in R.leaves_with_path(self.params):
                leaf.copy_(R.make_leaf(self.fam, self.conf, path, self.seed,
                                       self.device))

    def first_step(self) -> Dict[str, Any]:
        """One step from the seed's weights: its loss, the gradient as Adam
        got it (its first moment over 1 - beta1) leaf by leaf, and the
        stages' squared gradient norms (omega)."""
        rec = self.run(1, TF.Schedule({}), 0)
        beta1 = self.tcfg.optimizer.betas[0]
        m = rec.state.opt_state.m
        grad = {R.name(p): float(g.double().norm()) / (1 - beta1)
                for p, g in R.leaves_with_path(m)}
        omegas = [float(x) for x in rec.state.omegas.cpu()]
        out = {"loss": rec.losses[0], "grad": grad, "omegas": omegas,
               "seconds": rec.seconds}
        del rec
        return out

    def checked_steps(self, schedule: TF.Schedule, steps: int
                      ) -> Dict[str, Any]:
        """``steps`` steps from the seed's weights with ``schedule``'s
        failures: the losses and how far each leaf moved."""
        self.reset_weights()
        rec = self.run(steps, schedule, 0)
        moved = {}
        with torch.no_grad():
            for path, leaf in R.leaves_with_path(self.params):
                start = R.make_leaf(self.fam, self.conf, path, self.seed,
                                    self.device)
                moved[R.name(path)] = float((leaf - start).double().norm())
                del start
        out = {"losses": rec.losses, "moved": moved, "seconds": rec.seconds}
        del rec
        return out

    def close(self) -> None:
        """Drop the trainer, its window and the weights; give the cached
        blocks back."""
        telemetry.set_recorder(None)
        self.trainer.bench_params = None
        self.trainer = None
        self.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_dispatch(spans: List[dict]) -> dict:
    """The run's first ``window_dispatch`` span."""
    for span in spans:
        if span["name"] == "window_dispatch":
            return span
    raise RuntimeError("the run recorded no window_dispatch span")
