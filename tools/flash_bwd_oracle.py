"""How close the bf16 flash backward and its two plain oracles come to the
float64 gradients, on the card.

    python3 tools/flash_bwd_oracle.py [--seeds 200]

Run from a checkout's root on a machine with a card.  chip_smoke holds the
backward kernels against two bf16 oracles (``compare_bwd``): the plain
backward ``flash_attention_bwd_ref`` and PyTorch's autograd through
``flash_attention_ref``, each at ``GRAD_TOL`` (3e-2 x (1 + |oracle|) in
bf16).  At each shape below this tool draws ``--seeds`` inputs (seeds 1000
on, chip_smoke's ``qkv`` draw), runs chip_smoke's check, and for each draw
the check refuses prints one JSON line: for dq, dk and dv, the elements
that fail against each oracle, the first one's kernel, oracle and float64
values (autograd through ``flash_attention_ref`` on the inputs in float64),
and each of the three's largest error against float64.  The last line per
shape counts the refused draws.  The shapes: gemma-2b's and
h2o-danube-3-4b's head dims in chip_smoke's backward sweep at S 128 with a
window of 100 (GQA 32/8), and the examples' head dim 16 as a control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# (b, hq, hkv, s, d, causal, window)
SHAPES = ((2, 32, 8, 128, 256, True, 100), (2, 32, 8, 128, 120, True, 100),
          (2, 32, 8, 128, 16, True, 100))


def float64_grads(q, k, v, do, causal, window):
    leaves = [t.detach().double().requires_grad_() for t in (q, k, v)]
    o, _ = ref.flash_attention_ref(*leaves, causal=causal, window=window)
    return torch.autograd.grad(o, leaves, do.double())


def report(q, k, v, do, causal, window) -> dict:
    tol = C.GRAD_TOL[q.dtype]
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                       window)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o, _ = ref.flash_attention_ref(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(o, leaves, do)
    truth = float64_grads(q, k, v, do, causal, window)
    rep = {}
    for name, g, w, a, t in zip(("dq", "dk", "dv"), got, want, auto, truth):
        g, w, a = g.double(), w.double(), a.double()
        r = {"max_abs_error_vs_float64": {
            "kernel": float((g - t).abs().max()),
            "bwd_ref": float((w - t).abs().max()),
            "autograd": float((a - t).abs().max())}}
        for oracle_name, oracle in (("bwd_ref", w), ("autograd", a)):
            bad = (g - oracle).abs() > tol * (1 + oracle.abs())
            r[f"fails_vs_{oracle_name}"] = int(bad.sum())
            if bad.any():
                i = tuple(torch.nonzero(bad)[0].tolist())
                r[f"first_fail_vs_{oracle_name}"] = {
                    "index": list(i), "kernel": float(g[i]),
                    "oracle": float(oracle[i]), "float64": float(t[i])}
        rep[name] = r
    return rep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_oracle: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for b, hq, hkv, s, d, causal, window in SHAPES:
        shape = dict(b=b, hq=hq, hkv=hkv, s=s, d=d, causal=causal,
                     window=window, dtype="bfloat16")
        refused = 0
        for seed in range(1000, 1000 + args.seeds):
            gen = torch.Generator("cuda").manual_seed(seed)
            q, k, v = C.qkv(gen, b, hq, hkv, s, d, torch.bfloat16)
            do = torch.randn(q.shape, generator=gen,
                             device="cuda").to(torch.bfloat16)
            ok, err = C.compare_bwd(q, k, v, do, causal=causal,
                                    window=window)
            if not ok:
                refused += 1
                print(json.dumps({"shape": shape, "seed": seed, "err": err,
                                  **report(q, k, v, do, causal, window)}),
                      flush=True)
        print(json.dumps({"shape": shape, "seeds": args.seeds,
                          "refused": refused,
                          "nvidia_smi": C.smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
