"""Where the time of serving or training goes on the card, from
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch paper-llama-1.5b \
        --full --batch 8 --prompt-len 512 --decode-steps 8
    PYTHONPATH=src python -m repro_torch.launch.profile --arch paper-llama-1.5b \
        --full --batch 8 --prompt-len 512 --train-steps 3
    PYTHONPATH=src python -m repro_torch.launch.profile --arch paper-llama-1.5b \
        --full --batch 8 --prompt-len 512 --train-steps 16 --fuse-window 8
    PYTHONPATH=src python -m repro_torch.launch.profile --arch h2o-danube-3-4b \
        --full --layers 12 --batch 4 --train-steps 3 --strategy checkfree
    PYTHONPATH=src python -m repro_torch.launch.profile --arch mamba2-1.3b --full
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch granite-moe-3b-a800m --full --batch 4 --train-steps 16 \
        --fuse-window 8

Serving: builds the model and prompt as ``launch.serve`` does, warms up,
then takes prefill and decode apart.  Training (``--train-steps``): builds
the Trainer (``--strategy``, the config's stage count), warms up one step,
then profiles that many steps of the eager ``Trainer.step`` on batches of
``--batch`` x ``--prompt-len`` made on the device beforehand; with
``--fuse-window K`` > 1 it warms up one window (which captures the CUDA
graph), then profiles ``--train-steps / K`` windows of K steps through
``Trainer.run_window`` (staging the stacked numpy window, the replays, the
drain), on windows stacked beforehand (``--layers`` cuts the depth).  Each
phase
prints one JSON line: the wall time (host clock around work that ends in a
synchronize, without the profiler), the device busy time (the sum of the
CUDA kernels' durations in a profiled run of the same work), the device
span of that run (from its first kernel's start to its last kernel's end;
the profiler traces the device only), the device's idle share ``1 - busy /
span``, both from the one traced run,
the number of kernels launched, the device
time by family (the port's kernels: flash attention, the stage merge, the
SSD scan, its backward, Adam; cuBLAS matrix products; PyTorch's index
kernels, where the MoE routing and dispatch run; everything else), the
device time of each of the port's kernels by name, and the kernels that take the most device
time.  Decode and training
numbers are per step.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from collections import defaultdict
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.config import RecoveryConfig, TrainConfig
from repro_torch.configs import (ARCHS, PAPER_MODELS, get_config, get_stages,
                                 reduced)
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import SyntheticLM, batch_for, make_batches
from repro_torch.models.model import build_model
from repro_torch.recovery import available_strategies
from repro_torch.telemetry import log


def _wall_s(fn: Callable[[], None]) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _kernels(fn: Callable[[], None]) -> Tuple[dict, float]:
    """({kernel name: [calls, device us]}, the device span in us) of one
    profiled run of ``fn``."""
    torch.cuda.synchronize()
    # the device only: tracing the host's operators too slows a host-bound
    # step down and stretches the span
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = defaultdict(lambda: [0, 0.0])
    start, end = float("inf"), float("-inf")
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name][0] += 1
            out[e.name][1] += e.time_range.elapsed_us()
            start = min(start, e.time_range.start)
            end = max(end, e.time_range.end)
    if not out:
        raise RuntimeError("the profiler recorded no CUDA kernels")
    return out, end - start


# kernel families by name: the port's own kernels (the SSD scan's forward
# and its backward apart), cuBLAS's matrix products (nvjet / gemm / cutlass
# kernels), PyTorch's index kernels (gathers, scatters, sorts and scans:
# the MoE layer's routing and its dispatch and combine by index, besides
# the embedding's and the loss's gathers), and everything else (PyTorch's
# element-wise, reduction and copy kernels)
_FAMILIES = (("flash_attention", ("flash_fwd", "flash_bwd")),
             ("stage_merge", ("stage_merge",)),
             ("ssd_scan_bwd", ("ssd_bwd_",)),
             ("ssd_scan", ("ssd_scan",)),
             ("adam", ("adam_update_kernel", "sumsq_")),
             ("matmul", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
             ("index", ("indexSelect", "index_select", "index_elementwise",
                        "scatter_gather", "Sort", "sort", "scan", "Scan")))


# the port's kernel names within the profiler's demangled signatures
_OURS = re.compile(r"(flash_\w+|stage_merge\w*|ssd_scan\w*|ssd_bwd_\w+|"
                   r"adam_update\w*|sumsq_\w+)(<[^>]*>)?")


def _family(name: str) -> str:
    for family, keys in _FAMILIES:
        if any(k in name for k in keys):
            return family
    return "other"


def _report(phase: str, wall_s: float, traced: Tuple[dict, float], per: int,
            top: int = 8, **extra) -> None:
    kernels, span_us = traced
    busy_ms = sum(us for _, us in kernels.values()) / 1e3 / per
    span_ms = span_us / 1e3 / per
    wall_ms = wall_s * 1e3 / per
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    families = defaultdict(lambda: [0, 0.0])
    ours = defaultdict(lambda: [0, 0.0])
    for name, (n, us) in kernels.items():
        family = _family(name)
        families[family][0] += n
        families[family][1] += us
        if family not in ("matmul", "index", "other"):
            short = _OURS.search(name)
            key = short.group(0) if short else name
            ours[key][0] += n
            ours[key][1] += us
    log(json.dumps({
        "phase": phase, **extra, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_span_ms": span_ms, "idle_share": 1.0 - busy_ms / span_ms,
        "kernel_launches": sum(n for n, _ in kernels.values()) / per,
        "families": {f: {"calls": n / per, "ms": us / 1e3 / per}
                     for f, (n, us) in sorted(families.items())},
        "ours": {k: {"calls": n / per, "ms": us / 1e3 / per}
                 for k, (n, us) in sorted(ours.items())},
        "top": [{"name": name[:90], "calls": n / per, "ms": us / 1e3 / per}
                for name, (n, us) in rows]}))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-llama-1.5b",
                    choices=sorted(ARCHS) + sorted(PAPER_MODELS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=0,
                    help="profile this many training steps instead of "
                         "serving (0 = serve)")
    ap.add_argument("--strategy", default="checkfree_plus",
                    choices=available_strategies())
    ap.add_argument("--layers", type=int, default=0,
                    help="override the config's layer count (0 = keep)")
    ap.add_argument("--fuse-window", type=int, default=1,
                    help="profile training in fused windows of this many "
                         "steps (1 = eager steps)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers > 0:
        cfg = cfg.replace(num_layers=args.layers)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    if args.train_steps:
        _profile_train(cfg, args, card)
        return
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(args.seed))
    raw = SyntheticLM(cfg.vocab_size, seed=7).sample(
        np.random.default_rng(args.seed), args.batch, args.prompt_len)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in batch_for(cfg, raw).items() if k != "labels"}
    steps = args.decode_steps
    # the VLM's patches sit in the cache before the prompt
    capacity = cfg.num_patches + args.prompt_len + 3 * steps + 2

    def prefill():
        return model.prefill(batch, capacity)

    state = {}

    def decode():
        logits, cache = state["logits"], state["cache"]
        for _ in range(steps):
            nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
            logits, cache = model.decode_step(cache, nxt)
        state["logits"], state["cache"] = logits, cache

    state["logits"], state["cache"] = prefill()       # warm-up, both phases
    decode()
    shape = dict(arch=cfg.name, batch=args.batch, prompt=args.prompt_len,
                 card=card)
    _report("prefill", _wall_s(prefill), _kernels(prefill), 1, **shape)
    state["logits"], state["cache"] = prefill()
    _report("decode", _wall_s(decode), _kernels(decode), steps, steps=steps,
            **shape)


def _profile_train(cfg, args, card: str) -> None:
    stages = min(get_stages(args.arch), cfg.num_layers)
    k = max(args.fuse_window, 1)
    windows = -(-args.train_steps // k)
    tcfg = TrainConfig(global_batch=args.batch, microbatch=args.batch,
                       seq_len=args.prompt_len, steps=(windows + 1) * k,
                       fuse_window=k, seed=args.seed,
                       recovery=RecoveryConfig(strategy=args.strategy,
                                               num_stages=stages))
    trainer = Trainer(build_model(cfg, device="cuda", weights=False), tcfg)
    stream = make_batches(cfg, batch=args.batch, seq=args.prompt_len,
                          seed=args.seed)
    raw = [next(stream) for _ in range((windows + 1) * k)]
    state = {"state": trainer.init_state()}
    shape = dict(arch=cfg.name, layers=cfg.num_layers, strategy=args.strategy,
                 stages=stages, batch=args.batch, seq=args.prompt_len,
                 fuse_window=k, card=card)
    if k == 1:
        # made before the clock starts, as chip_smoke times Trainer.step alone
        batches = [trainer.device_batch(b) for b in raw]

        def steps(n: int) -> None:
            for batch in batches[:n]:
                state["state"], _, _ = trainer.step(state["state"], batch)

        steps(1)                                       # warm-up
        n = args.train_steps
        _report("train_step", _wall_s(lambda: steps(n)),
                _kernels(lambda: steps(n)), n, top=12, **shape)
        return
    stacked = [{key: np.stack([b[key] for b in raw[i * k:(i + 1) * k]])
                for key in raw[0]} for i in range(windows + 1)]

    def run(ws) -> None:
        for window in ws:
            state["state"], _ = trainer.run_window(state["state"], window)

    run(stacked[:1])                  # warm-up: the eager step, the capture
    _report("train_window", _wall_s(lambda: run(stacked[1:])),
            _kernels(lambda: run(stacked[1:])), windows * k, top=12,
            replays=trainer.window.replays, **shape)


if __name__ == "__main__":
    main()
