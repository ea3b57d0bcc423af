"""Compare two checkouts of the PyTorch port on the card, one process at a
time, in alternating order.

    python3 tools/chip_compare.py serve A B
    python3 tools/chip_compare.py profile A B
    python3 tools/chip_compare.py ssd A B
    python3 tools/chip_compare.py flash-bits A B
    python3 tools/chip_compare.py spmd A B
    python3 tools/chip_compare.py single-rounding SRC DST

A and B are checkouts that hold ``chip_smoke.py`` and ``src/`` (``.`` for
this one, or a ``git archive`` of another commit unpacked somewhere).  Each
run is a fresh process that builds the checkout's kernels (cached in its own
``build/``) and uses its own ``chip_smoke.py``, so a checkout is measured by
its own code.  Every process prints JSON lines labelled with its checkout.

* ``serve``: A, B four times; each process warms up and times seven
  ``generate`` calls of chip_smoke's paper-llama-1.5b serving run (batch 8,
  prompt 512, 32 new tokens) and prints each prefill ms and decode ms a
  token, and their medians.
* ``profile``: A, B, B, A; each process runs chip_smoke's paper-llama-1.5b
  serve phase and ``launch.profile`` on it (wall ms, device busy ms, idle
  share a prefill and a decode step).
* ``ssd``: A, B, B, A; each process runs chip_smoke's SSD sweep (counting
  failures instead of stopping), the worst y and state errors over three
  seeds, with and without a starting state, at both serving shapes against
  both plain versions, each as |err| / (1 + |w|), the kernel's time there,
  and the serve phases of mamba2-1.3b and zamba2-2.7b (logits against the
  plain-version prefill).  Both checkouts need a chip_smoke whose
  ``ssd_cases`` yields the B and C offset as a sixth field.
* ``flash-bits``: A, B; each process runs the three flash kernels (forward
  out and lse, dq, dk and dv) over a sweep at equal query and key lengths
  (fp32 and bf16, every head dim, MHA, GQA and MQA, causal, windowed and
  full, S 1 to 1000) on the same seeded inputs and prints a SHA-256 of each
  output's bytes; the comparison passes (exit 0) only where B's bits equal
  A's in every case.
* ``spmd``: A, B, B, A; each process runs chip_smoke's ``train_spmd``
  phase (paper-llama-1.5b, six ranks on the card, ``checkfree_plus``, 12
  steps in windows of 4, against the host backend's run), whose JSON line
  holds the ms a step and the windows' ms, then its own line with the
  phase's seconds.
* ``single-rounding``: copies checkout SRC (``chip_smoke.py`` and ``src/``)
  to DST with the bf16 SSD kernel rounding att and the state copy to bf16
  once instead of splitting them into hi and lo parts (x w stays split):
  the build whose errors ``csrc/ssd_scan.cu`` gives as the reason for the
  split.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.abspath(__file__)
ORDERS = {"serve": "AB" * 4, "profile": "ABBA", "ssd": "ABBA",
          "flash-bits": "AB", "spmd": "ABBA"}


def _flash_bits(CS, torch, out) -> None:
    """SHA-256 of every output of the flash kernels over the equal-length
    sweep (the wrappers' signatures at Sq == Sk are the same before and
    after keys of another length were allowed)."""
    import hashlib
    FA = CS.FA
    gen = torch.Generator("cuda").manual_seed(5)
    digests = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in FA.FWD_HEAD_DIMS:
            for hq, hkv in ((16, 16), (8, 2), (8, 1)):
                for causal, window in ((True, 0), (True, 100), (False, 0)):
                    for s in (1, 63, 200, 1000):
                        q, k, v = CS.qkv(gen, 2, hq, hkv, s, d, dtype)
                        do = torch.randn(q.shape, generator=gen,
                                         device="cuda").to(dtype)
                        o, lse = FA.flash_attention_fwd(
                            q, k, v, causal=causal, window=window)
                        delta = (do.float() * o.float()).sum(-1)
                        dq = FA.flash_attention_bwd_dq(
                            q, k, v, do, lse, delta, causal=causal,
                            window=window)
                        dk, dv = FA.flash_attention_bwd_dkv(
                            q, k, v, do, lse, delta, causal=causal,
                            window=window)
                        torch.cuda.synchronize()
                        h = hashlib.sha256()
                        for t in (o, lse, dq, dk, dv):
                            h.update(t.contiguous().view(torch.uint8).cpu()
                                     .numpy().tobytes())
                        digests.append(h.hexdigest())
    out(flash_bits=digests)


def _worker(mode: str, tree: str, label: str) -> None:
    os.chdir(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as CS

    def out(**kw):
        print(json.dumps({"label": label, "tree": tree, "mode": mode, **kw}),
              flush=True)

    out(card=CS.smi())
    t0 = time.perf_counter()
    CS.build.build()
    out(build_s=time.perf_counter() - t0)
    spec = CS.SERVE
    if mode == "serve":
        cfg = CS.get_config(spec["arch"])
        model = CS.Model(cfg, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
        raw = CS.SyntheticLM(cfg.vocab_size, seed=7).sample(
            np.random.default_rng(0), spec["batch"], spec["prompt"])
        toks = torch.from_numpy(CS.batch_for(cfg, raw)["tokens"]).cuda()
        CS.generate(model, toks, new_tokens=2)
        pre, dec = [], []
        for _ in range(7):
            r = CS.generate(model, toks, new_tokens=spec["new_tokens"])
            pre.append(r.prefill_s * 1e3)
            dec.append(r.decode_s / (spec["new_tokens"] - 1) * 1e3)
        out(arch=spec["arch"], prefill_ms=pre, decode_ms_per_token=dec,
            prefill_median=float(np.median(pre)),
            decode_median=float(np.median(dec)))
    elif mode == "profile":
        CS.phase_serve(spec, "serve")
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.profile", "--arch",
             spec["arch"], "--full", "--batch", str(spec["batch"]),
             "--prompt-len", str(spec["prompt"]), "--decode-steps", "8"],
            env=env, capture_output=True, text=True, timeout=600, check=True)
        for ln in r.stdout.splitlines():
            if ln.startswith("{"):
                d = json.loads(ln)
                d.pop("top", None)
                out(profile=d)
    elif mode == "flash-bits":
        _flash_bits(CS, torch, out)
    elif mode == "spmd":
        CS.phase_env()
        t0 = time.perf_counter()
        CS.phase_train_spmd()
        out(phase="train_spmd", seconds=time.perf_counter() - t0)
    elif mode == "ssd":
        gen = torch.Generator("cuda").manual_seed(3)
        cases = failures = 0
        for dtype, shp, chunk, real, init, offset in CS.ssd_cases():
            ok = CS.compare_ssd(*CS.ssd_inputs(
                gen, **shp, dtype=dtype, real=real, init=init, strided=real,
                offset=offset), chunk)[0]
            cases, failures = cases + 1, failures + (not ok)
        out(sweep_cases=cases, sweep_failures=failures)
        for name, shp in CS.SSD_SERVE.items():
            worst = {"y": 0.0, "state": 0.0}
            for seed in (3, 4, 5):
                g = torch.Generator("cuda").manual_seed(seed)
                for init in (False, True):
                    xb, a, bm, cm, st = CS.ssd_inputs(
                        g, **shp, dtype=torch.bfloat16, real=True,
                        strided=True, init=init)
                    y, s = CS.SSD.ssd_scan(xb, a, bm, cm, chunk=CS.SSD_CHUNK,
                                           init_state=st)
                    wy, ws = CS.ref.ssd_scan_ref(
                        *(v.transpose(1, 2) for v in (xb, a, bm, cm)), st)
                    for want_y, want_s in (
                            CS.ref.ssd_chunked(xb, a, bm, cm, CS.SSD_CHUNK, st),
                            (wy.transpose(1, 2), ws)):
                        want_y = want_y.float()
                        worst["y"] = max(worst["y"], float(
                            ((y.float() - want_y).abs()
                             / (1 + want_y.abs())).max()))
                        worst["state"] = max(worst["state"], float(
                            ((s - want_s).abs() / (1 + want_s.abs())).max()))
            g = torch.Generator("cuda").manual_seed(3)
            xb, a, bm, cm, _ = CS.ssd_inputs(g, **shp, dtype=torch.bfloat16,
                                             real=True, strided=True)
            ms = CS.time_ms(lambda: CS.SSD.ssd_scan(xb, a, bm, cm,
                                                    chunk=CS.SSD_CHUNK))
            out(arch=name, y_rel_err=worst["y"], state_rel_err=worst["state"],
                ms=ms)
        for serve, phase in ((CS.SERVE_SSM, "serve_ssm"),
                             (CS.SERVE_HYBRID, "serve_hybrid")):
            try:           # the phase prints its line before it judges it
                CS.phase_serve(serve, phase)
            except AssertionError:
                traceback.print_exc()


# (what the kept kernel does, what the single-rounding build does instead)
_SINGLE_ROUNDING = (
    ("(STAGES * (2 * BC_TILE + X_TILE) + 2 * X_TILE + 2 * S_TILE) * 16",
     "(STAGES * (2 * BC_TILE + X_TILE) + 2 * X_TILE + S_TILE) * 16"),
    ("float* As = reinterpret_cast<float*>(Ss + 2 * Tl::S_TILE);",
     "float* As = reinterpret_cast<float*>(Ss + Tl::S_TILE);"),
    ("""          split_bf16x2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1],
                       reinterpret_cast<uint32_t*>(Ss + i)[t],
                       reinterpret_cast<uint32_t*>(Ss + Tl::S_TILE + i)[t]);""",
     """          reinterpret_cast<uint32_t*>(Ss + i)[t] =
              sm90::pack_bf16x2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);"""),
    ("""              uint32_t sh[4], sl[4];
              frag_b_nk<NCH>(sh, Ss, n, kk, lane);
              frag_b_nk<NCH>(sl, Ss + Tl::S_TILE, n, kk, lane);
              sm90::mma_bf16_16816(ye[n], ac, sh[0], sh[1]);
              sm90::mma_bf16_16816(ye[n], ac, sl[0], sl[1]);
              sm90::mma_bf16_16816(ye[n + 1], ac, sh[2], sh[3]);
              sm90::mma_bf16_16816(ye[n + 1], ac, sl[2], sl[3]);""",
     """              uint32_t sh[4];
              frag_b_nk<NCH>(sh, Ss, n, kk, lane);
              sm90::mma_bf16_16816(ye[n], ac, sh[0], sh[1]);
              sm90::mma_bf16_16816(ye[n + 1], ac, sh[2], sh[3]);"""),
    ("""        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(s[r >> 1][2 * (r & 1)], s[r >> 1][2 * (r & 1) + 1],
                       ah[r], al[r]);""",
     """        uint32_t ah[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ah[r] = sm90::pack_bf16x2(s[r >> 1][2 * (r & 1)],
                                    s[r >> 1][2 * (r & 1) + 1]);"""),
    ("""          sm90::mma_bf16_16816(yi[n], ah, vb[0], vb[1]);
          sm90::mma_bf16_16816(yi[n], al, vb[0], vb[1]);
          sm90::mma_bf16_16816(yi[n + 1], ah, vb[2], vb[3]);
          sm90::mma_bf16_16816(yi[n + 1], al, vb[2], vb[3]);""",
     """          sm90::mma_bf16_16816(yi[n], ah, vb[0], vb[1]);
          sm90::mma_bf16_16816(yi[n + 1], ah, vb[2], vb[3]);"""),
)


def single_rounding(src: str, dst: str) -> None:
    os.makedirs(dst)
    shutil.copy2(os.path.join(src, "chip_smoke.py"), dst)
    shutil.copytree(os.path.join(src, "src"), os.path.join(dst, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "src", "repro_torch", "csrc", "ssd_scan.cu")
    with open(path) as f:
        text = f.read()
    for kept, single in _SINGLE_ROUNDING:
        if text.count(kept) != 1:
            raise SystemExit(f"single-rounding: {path} no longer holds "
                             f"{kept.strip()[:60]!r}")
        text = text.replace(kept, single)
    with open(path, "w") as f:
        f.write(text)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["serve", "profile", "ssd",
                                     "flash-bits", "spmd",
                                     "single-rounding"])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _worker(args.mode, os.path.abspath(args.worker[0]), args.worker[1])
        return 0
    if args.mode == "single-rounding":
        single_rounding(args.a, args.b)
        return 0
    trees = {"A": args.a, "B": args.b}
    rc = 0
    bits = {}
    for key in ORDERS[args.mode]:
        res = subprocess.run(
            [sys.executable, HERE, args.mode, args.a, args.b, "--worker",
             trees[key], key], timeout=900, capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        sys.stderr.write(res.stderr)
        rc |= res.returncode
        for ln in res.stdout.splitlines():
            if ln.startswith("{") and "flash_bits" in ln:
                bits[key] = json.loads(ln)["flash_bits"]
    if args.mode == "flash-bits":
        same = len(bits) == 2 and bits["A"] == bits["B"]
        print(json.dumps({"mode": "flash-bits", "cases": len(bits.get("A",
                          [])), "equal": same, "differing": [
                              i for i, (a, b) in enumerate(zip(
                                  bits.get("A", []), bits.get("B", [])))
                              if a != b]}), flush=True)
        rc |= not same
    return rc


if __name__ == "__main__":
    sys.exit(main())
