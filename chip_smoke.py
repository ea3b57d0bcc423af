#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (built for sm_90a: H100).

    python3 chip_smoke.py

Drives only the port (``src/repro_torch``), on the card.  Each phase prints
one JSON line; any failure raises, so the script exits non-zero and prints no
result.  Phases:

1. env     — card, power limit, torch/CUDA versions; TF32 off for fp32.
2. build   — compiles every CUDA source under src/repro_torch/csrc.
3. kernel  — the flash-attention kernel against its plain version over
             dtypes, GQA groups, head dims, masks, ragged lengths and the
             serving shape; then kernel, plain version and SDPA (as a
             yardstick only) timed at the serving shape with CUDA events
             around back-to-back calls, beside the bound.
4. model   — paper-llama-1.5b at full width cut to 2 layers, fp32: prefill
             logits on the card (kernel) against the port on the CPU (plain).
5. serve   — paper-llama-1.5b, all 24 layers, random weights from a seeded
             generator on the card: batch 8, prompt 512, 32 new tokens
             through ``launch.serve.generate``; the kernel must launch once
             per layer in the prefill.  Then, outside the counted run, the
             prefill with the kernel against the prefill with the plain
             version, and the kernel against the plain version on each
             layer's own attention inputs.
6. kernels — one line for every kernel: launches, error, times, bound.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, batch_for  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

# H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core peak, fp32 peak
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# tests/test_kernels.py's tolerances; lse in fp32 for both dtypes
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
LSE_TOL = 1e-4
# bf16 at the serving shape and on the serving path's own inputs: kernel and
# plain version both round an fp32 result to bf16, so they differ by at most
# one bf16 ulp, 2**-7 of |w| < 1e-2 * (1 + |w|)
SERVE_TOL = 1e-2
# the full 24-layer bf16 prefill with the kernel against the same prefill with
# the plain version, as a share of the largest |logit|
# (tests/test_smoke_archs.py's bf16 limit)
SERVE_LOGITS_TOL = 0.05
# the 2-layer fp32 model on the card against the CPU: cuBLAS and the CPU's
# BLAS sum d=2048 and d_ff=5504 products in different orders
MODEL_TOL = 1e-3
SERVE = dict(arch="paper-llama-1.5b", batch=8, prompt=512, new_tokens=32)
ATTN_SHAPE = dict(b=8, h=16, s=512, d=128)   # what serving gives the kernel


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def qkv(gen, b, hq, hkv, s, d, dtype):
    shapes = ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))
    return [torch.randn(sh, generator=gen, device="cuda").to(dtype)
            for sh in shapes]


def visible_pairs(s: int, causal: bool, window: int) -> int:
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    m = np.ones((s, s), bool)
    if causal:
        m &= k <= q
    if window > 0:
        m &= k > q - window
    return int(m.sum())


def time_ms(fn, groups: int = 21, per_group: int = 20, warmup: int = 3
            ) -> float:
    """Device ms per call: the median over ``groups`` of one CUDA-event pair
    around ``per_group`` back-to-back calls, divided by ``per_group``.

    Each group is queued behind a ~10 ms device sleep, so the host has
    enqueued every call before the start event fires and the events see
    device time only, not the host's work before each launch.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_group)
    return float(np.median(times))


def compare(q, k, v, *, causal: bool, window: int, tol: float) -> tuple:
    """The kernel against its plain version on the same inputs, element-wise:
    out within ``tol * (1 + |want|)``, lse within ``LSE_TOL * (1 + |lse|)``.
    Returns (ok, max |out error|, max |lse error|)."""
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)
    o, w = out.float(), want.float()
    ok = bool(((o - w).abs() <= tol * (1 + w.abs())).all())
    ok &= bool(((lse - want_lse).abs() <= LSE_TOL * (1 + want_lse.abs())).all())
    ok &= bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    return ok, float((o - w).abs().max()), float((lse - want_lse).abs().max())


def phase_env() -> str:
    card = smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    info = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in r["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, r in info.items()}
    emit("build", seconds=seconds, sources=sorted(info), ptxas=ptxas)


def sweep_cases():
    """(dtype, b, hq, hkv, s, d, causal, window, tol) of the kernel sweep."""
    b, h, s, d = (ATTN_SHAPE[x] for x in "bhsd")
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in ((16, 16), (32, 8), (4, 1)):
            for dd in (64, 128):
                for causal, window in ((True, 0), (True, 100), (False, 0)):
                    for ss in (128, 1000, 2048):
                        yield (dtype, 1 if ss == 2048 else 2, hq, hkv, ss, dd,
                               causal, window, TOL[dtype])
        # the serving shape, where bf16 is held to one ulp
        yield (dtype, b, h, h, s, d, True, 0,
               TOL[dtype] if dtype == torch.float32 else SERVE_TOL)


def phase_kernel() -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    cases = failures = 0
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    for dtype, b, hq, hkv, s, d, causal, window, tol in sweep_cases():
        q, k, v = qkv(gen, b, hq, hkv, s, d, dtype)
        ok, out_err, lse_err = compare(q, k, v, causal=causal, window=window,
                                       tol=tol)
        name = str(dtype).split(".")[1]
        worst[name][0] = max(worst[name][0], out_err)
        worst[name][1] = max(worst[name][1], lse_err)
        cases += 1
        if not ok:
            failures += 1
            print(f"MISMATCH dtype={name} b={b} hq={hq} hkv={hkv} d={d} "
                  f"causal={causal} window={window} s={s}", file=sys.stderr)
    emit("kernel_check", kernel="flash_attention_fwd", cases=cases,
         failures=failures,
         max_abs_err={k: {"out": v[0], "lse": v[1]} for k, v in worst.items()},
         tol={"float32": TOL[torch.float32], "bfloat16": TOL[torch.bfloat16],
              "bfloat16_serving_shape": SERVE_TOL, "lse": LSE_TOL})
    if failures:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain "
                             f"version in {failures} of {cases} cases")

    # the serving shape: bf16, causal, one layer of paper-llama-1.5b
    b, h, s, d = (ATTN_SHAPE[x] for x in "bhsd")
    q, k, v = qkv(gen, b, h, h, s, d, torch.bfloat16)
    ok, err, lse_err = compare(q, k, v, causal=True, window=0, tol=SERVE_TOL)
    if not ok:
        raise AssertionError(f"serving shape: out error {err}, lse error "
                             f"{lse_err}")
    kernel_ms = time_ms(lambda: FA.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    # q, k, v read once; out (like q) and the fp32 lse written once
    nbytes = (2 * q.numel() * q.element_size() + k.numel() * k.element_size()
              + v.numel() * v.element_size() + b * h * s * 4)
    flops = 4 * b * h * d * visible_pairs(s, True, 0)
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[torch.bfloat16] * 1e3
    row = {"name": "flash_attention_fwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:39",
           "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    emit("kernel_time", shape=dict(ATTN_SHAPE, dtype="bfloat16", causal=True),
         bytes=nbytes, flops=flops, **{k: row[k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}, lse_err=lse_err, tol=SERVE_TOL,
         library="scaled_dot_product_attention",
         timing="median of 21 groups of 20 back-to-back calls, CUDA events")
    return row


def phase_model() -> None:
    cfg = get_config(SERVE["arch"]).replace(num_layers=2, dtype="float32")
    params = Model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0)).params
    cpu = Model(cfg, params, device="cpu")
    card = Model(cfg, params, device="cuda")
    raw = SyntheticLM(cfg.vocab_size, seed=7).sample(
        np.random.default_rng(1), 1, 256)
    toks = torch.from_numpy(batch_for(cfg, raw)["tokens"])
    before = FA.launches
    logits, cache = card.prefill({"tokens": toks.cuda()}, 256)
    torch.cuda.synchronize()
    launched = FA.launches - before
    want, want_cache = cpu.prefill({"tokens": toks}, 256)
    err = float((logits.cpu() - want).abs().max())
    cache_err = float((cache["k"].cpu() - want_cache["k"]).abs().max())
    scale = float(want.abs().max())
    emit("model", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, batch=1, prompt=256, kernel_launches=launched,
         logits_max_abs_err=err, logits_max_abs=scale,
         cache_k_max_abs_err=cache_err, tol=MODEL_TOL)
    if launched != cfg.num_layers:
        raise AssertionError(f"{launched} kernel launches for "
                             f"{cfg.num_layers} layers")
    if not (math.isfinite(err) and err <= MODEL_TOL * (1 + scale)
            and cache_err <= MODEL_TOL):
        raise AssertionError(f"card vs CPU: logits {err}, cache {cache_err}")
    del cpu, card, params, cache, want_cache


def phase_serve() -> tuple:
    cfg = get_config(SERVE["arch"])
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    raw = SyntheticLM(cfg.vocab_size, seed=7).sample(
        np.random.default_rng(0), SERVE["batch"], SERVE["prompt"])
    toks = torch.from_numpy(batch_for(cfg, raw)["tokens"]).cuda()
    generate(model, toks, new_tokens=2)                  # warm-up
    torch.cuda.reset_peak_memory_stats()

    FA.launches = 0
    res = generate(model, toks, new_tokens=SERVE["new_tokens"])
    launches = FA.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # comparison runs, after the counted one: the same prefill with the
    # kernel and with the plain version, recording the attention inputs that
    # the serving path gives the kernel
    capacity = SERVE["prompt"] + SERVE["new_tokens"]
    logits, _ = model.prefill({"tokens": toks}, capacity)
    seen = []

    def plain(q, k, v, *, causal, window):
        seen.append((q, k, v, causal, window))
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

    kernel, FA.flash_attention_fwd = FA.flash_attention_fwd, plain
    try:
        want, _ = model.prefill({"tokens": toks}, capacity)
    finally:
        FA.flash_attention_fwd = kernel
    logits, want = logits.float(), want.float()
    logits_err = float((logits - want).abs().max())
    logits_scale = float(want.abs().max())
    first_ok = bool((logits[:, -1].argmax(-1).cpu().numpy()
                     == res.tokens[:, 0]).all())
    attn_fail, attn_err, attn_lse_err = 0, 0.0, 0.0
    for q, k, v, causal, window in seen:
        ok, err, lse_err = compare(q, k, v, causal=causal, window=window,
                                   tol=SERVE_TOL)
        attn_fail += not ok
        attn_err, attn_lse_err = max(attn_err, err), max(attn_lse_err, lse_err)

    steps = SERVE["new_tokens"] - 1
    new = SERVE["batch"] * SERVE["new_tokens"]
    emit("serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, head_dim=cfg.resolved_head_dim,
         vocab=cfg.vocab_size, dtype=cfg.dtype,
         params=sum(p.numel() for p in model.parameters()),
         batch=SERVE["batch"], prompt=SERVE["prompt"],
         new_tokens=SERVE["new_tokens"], init_s=init_s,
         prefill_ms=res.prefill_s * 1e3,
         decode_ms_per_token=res.decode_s / steps * 1e3,
         decode_tokens_per_s=SERVE["batch"] * steps / res.decode_s,
         tokens_per_s=new / (res.prefill_s + res.decode_s),
         peak_memory_gib=peak_gib, flash_launches=launches,
         first_tokens=res.tokens[0, :8].tolist(),
         first_token_is_prefill_argmax=first_ok,
         logits_vs_plain_max_abs_err=logits_err, logits_max_abs=logits_scale,
         logits_tol=SERVE_LOGITS_TOL, attention_inputs_checked=len(seen),
         attention_failures=attn_fail, attention_max_abs_err=attn_err,
         attention_lse_max_abs_err=attn_lse_err, attention_tol=SERVE_TOL)
    if launches != cfg.num_layers:
        raise AssertionError(f"prefill launched the flash kernel {launches} "
                             f"times for {cfg.num_layers} layers")
    if res.tokens.shape != (SERVE["batch"], SERVE["new_tokens"]) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"bad generation {res.tokens.shape}")
    if not first_ok:
        raise AssertionError("the first generated tokens are not the argmax "
                             "of the prefill logits")
    if not (math.isfinite(logits_err)
            and logits_err <= SERVE_LOGITS_TOL * logits_scale):
        raise AssertionError(f"prefill with the kernel vs the plain version: "
                             f"logits {logits_err} of {logits_scale}")
    if len(seen) != cfg.num_layers or attn_fail:
        raise AssertionError(f"the kernel disagrees with its plain version on "
                             f"{attn_fail} of {len(seen)} serving-path inputs")
    return launches, attn_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs the "
              "card", file=sys.stderr)
        return 1
    card = phase_env()
    phase_build()
    row = phase_kernel()
    phase_model()
    row["launches"], serve_err = phase_serve()
    row["max_abs_err"] = max(row["max_abs_err"], serve_err)
    print(card)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
