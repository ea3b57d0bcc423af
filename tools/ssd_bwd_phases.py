"""Where the bf16 SSD backward's time goes on the card, without ``ncu``.

    python3 tools/ssd_bwd_phases.py

Run from a checkout's root on a machine with a card.  At both of
chip_smoke's SSD training shapes (``SSD_TRAIN``: one mamba2-1.3b layer at
batch 8, one zamba2-2.7b layer at batch 4) it prints one JSON line each of

* ``ms``: the backward's time as chip_smoke takes it (``time_ms``, 11
  groups of 5 calls, CUDA events), after a check against the plain version;
* ``kernels_us``: the device time of each kernel of one call (walk and
  summing pass), from ``torch.profiler`` over five calls;
* ``phase_share``: the share of the walk kernel's warp cycles in each of
  its phases, from a copy of ``csrc/ssd_scan_bwd.cu`` with a ``clock64()``
  mark at each phase boundary, every warp's lane 0 adding the cycles since
  its last mark into a ``__device__`` array (barrier waits count in
  ``barriers``).  The copy is built beside the port's kernels with their
  nvcc flags; a mark whose anchor the source no longer has stops the tool.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402

PHASES = ("fwd walk", "fwd wait", "barriers", "issue loads", "phase 1",
          "phase 2 tiles", "phase 3 dx dB dC dcs", "dS update and <dS, S>")
MARK = ("do { const unsigned long long now = clock64(); if (lane == 0) "
        "atomicAdd(&g_cyc[{i}], now - last); last = now; } while (0);")

# (anchor, the marks before it, the marks after it): a mark adds the cycles
# since the warp's last mark to its phase
ANCHORS = (
    ("  // ---- (a) the forward walk", (), ("START",)),
    ("    sm90::cp_async_wait<0>();           // chunk c has landed", (0,), ()),
    ("    if (c + 1 < nc) load(c + 1, (c + 1) % STAGES, false);", (1,), ()),
    ("  // the entry states are in device memory", (0,), ()),
    ("    sm90::cp_async_wait<0>();\n    __syncthreads();\n    if (c > 0)",
     (7,), ()),
    ("    if (c > 0) load(c - 1, (step + 1) % STAGES, true);", (2,), ()),
    ("    const uint4* bs = Bt(stage);", (3,), ()),
    ("    __syncthreads();\n\n    // ---- 2:", (4,), ()),
    ("    float colsum[2] = {0.f, 0.f};", (2,), ()),
    ("    __syncthreads();                    // G2^T and M's sums are in",
     (5,), ()),
    ("    // ---- 3: tokens [r0, r0 + 16)", (2,), ()),
    ("    // dS <- 2^cs_L dS + (e^cs dy)^T C, each warp its own part", (6,), ()),
)


def instrumented_source() -> str:
    src = (ROOT / "src/repro_torch/csrc/ssd_scan_bwd.cu").read_text()
    head, sep, rest = src.partition("namespace {")
    src = head + "__device__ unsigned long long g_cyc[16];\n" + sep + rest
    kernel = src.index("ssd_bwd_bf16_kernel(const Params p) {")
    body_end = src.index("// fp32: CUDA cores")
    body = src[kernel:body_end]
    for anchor, before, after in ANCHORS:
        if body.count(anchor) != 1:
            raise SystemExit(f"anchor not found once: {anchor!r}")
        marks = "".join(MARK.replace("{i}", str(i)) + "\n" for i in before)
        if after == ("START",):
            marks += "  unsigned long long last = clock64();\n"
        body = body.replace(anchor, marks + anchor)
    src = src[:kernel] + body + src[body_end:]
    return src + '''
extern "C" int read_cycles(unsigned long long* out) {
  const cudaError_t e = cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc));
  unsigned long long zero[16] = {};
  cudaMemcpyToSymbol(g_cyc, zero, sizeof(zero));
  return (int)e;
}
'''


def instrumented_library() -> ctypes.CDLL:
    out = build.BUILD_DIR / "ssd_bwd_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "ssd_scan_bwd_marked.cu"
    cu.write_text(instrumented_source())
    so = out / "ssd_scan_bwd_marked.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                        str(ROOT / "src/repro_torch/csrc"), "-o", str(so),
                        str(cu)], capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    lib.read_cycles.argtypes = [ctypes.c_void_p]
    lib.ssd_scan_bwd.argtypes = SSD._ARGTYPES["ssd_scan_bwd"]
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(C.smi(), flush=True)
    marked = instrumented_library()
    gen = torch.Generator("cuda").manual_seed(4)
    for arch, shp in C.SSD_TRAIN.items():
        xb, a, bm, cm, _ = C.ssd_inputs(gen, **shp, dtype=torch.bfloat16,
                                        real=True, strided=True)
        dy = torch.randn(xb.shape, generator=gen,
                         device="cuda").to(torch.bfloat16)

        def run():
            return SSD.ssd_scan_bwd(xb, a, bm, cm, dy, chunk=C.SSD_CHUNK)

        ok, err = C.compare_ssd_bwd(xb, a, bm, cm, None, dy, None,
                                    C.SSD_CHUNK)
        ms = C.time_ms(run, groups=11, per_group=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = re.search(r"ssd_bwd_\w+", e.name)
                key = name.group(0) if name else e.name[:60]
                kernels.setdefault(key, []).append(e.time_range.elapsed_us())
        entry = SSD._entry
        SSD._entry = lambda name="ssd_scan": (marked, marked.ssd_scan_bwd)
        try:
            cycles = (ctypes.c_ulonglong * 16)()
            run()
            torch.cuda.synchronize()
            marked.read_cycles(cycles)        # the first call's, dropped
            run()
            torch.cuda.synchronize()
            marked.read_cycles(cycles)
        finally:
            SSD._entry = entry
        total = sum(cycles[i] for i in range(len(PHASES)))
        print(json.dumps({
            "arch": arch, "shape": shp, "ok": bool(ok), "max_abs_err": err,
            "ms": ms,
            "kernels_us": {k: sum(v) / len(v) for k, v in kernels.items()},
            "phase_share": {p: cycles[i] / total
                            for i, p in enumerate(PHASES)},
            "warp_cycles": total}), flush=True)


if __name__ == "__main__":
    main()
