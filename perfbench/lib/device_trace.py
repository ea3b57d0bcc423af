"""The device trace of a profiled stretch of training, reduced to what the
per-layer metrics and the breakdown read.

``torch.profiler`` traces the card only (tracing the host's operators too
would slow a host-bound step and stretch the span).  From its device
events this module gives the busy time (the union of the operations'
intervals, so that overlapping streams count once), the span from the
first operation's start to the last one's end, the time by operation name
and by family, and the idle gaps between operations, each labelled with the
program's host span (``window_dispatch``, ``window_drain``, ``recovery``)
that covers most of it.

The families and their name patterns are a copy of the program's
``launch/profile.py`` (``_FAMILIES``, ``_OURS``): the port's own kernels,
cuBLAS's matrix products, PyTorch's index kernels, and everything else,
which is PyTorch's element-wise, reduction and copy kernels.

To place device times on the host's clock, a one-element fill is launched
right after a synchronize, at a host time read just before; its device
start minus that time is the offset (good to the launch latency, some
microseconds).
"""
from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import torch

FAMILIES = (("flash_attention", ("flash_fwd", "flash_bwd")),
            ("stage_merge", ("stage_merge",)),
            ("ssd_scan_bwd", ("ssd_bwd_",)),
            ("ssd_scan", ("ssd_scan",)),
            ("adam", ("adam_update_kernel", "sumsq_")),
            ("matmul", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
            ("index", ("indexSelect", "index_select", "index_elementwise",
                       "scatter_gather", "Sort", "sort", "scan", "Scan")))

OURS = re.compile(r"(flash_\w+|stage_merge\w*|ssd_scan\w*|ssd_bwd_\w+|"
                  r"adam_update\w*|sumsq_\w+)(<[^>]*>)?")


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def short_name(name: str) -> str:
    m = OURS.search(name)
    return m.group(0) if m else name[:120]


@dataclasses.dataclass
class Trace:
    """Device operations of one profiled stretch: (name, start, end) in
    seconds on the host's clock (``time.perf_counter``)."""
    ops: List[Tuple[str, float, float]]
    host_s: float                   # host seconds of the profiled call

    @property
    def start(self) -> float:
        return min(s for _, s, _ in self.ops)

    @property
    def end(self) -> float:
        return max(e for _, _, e in self.ops)

    @property
    def span_s(self) -> float:
        return self.end - self.start

    def merged(self) -> List[Tuple[float, float]]:
        """The union of the operations' intervals, in order."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged())

    def idle_within(self, a: float, b: float) -> float:
        """Seconds of [a, b] (clipped to the span) in which no operation
        ran on the device."""
        a, b = max(a, self.start), min(b, self.end)
        if b <= a:
            return 0.0
        busy = sum(max(0.0, min(e, b) - max(s, a))
                   for s, e in self.merged())
        return (b - a) - busy

    def seconds_by(self, key: Callable[[str], str]) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            out[key(name)] += e - s
        return dict(out)

    def matching(self, patterns: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds a pattern."""
        return sum(e - s for name, s, e in self.ops
                   if any(p in name for p in patterns))

    def gaps(self, spans: Sequence[dict], t0: float,
             top: int = 10) -> List[Tuple[str, float]]:
        """The longest idle gaps, each labelled with the host span
        (recorder-relative ``ts_us``/``dur_us``, the recorder's origin
        ``t0``) that overlaps it most, else "host between spans"."""
        iv = self.merged()
        found = []
        for (_, a), (b, _) in zip(iv, iv[1:]):
            if b > a:
                found.append((b - a, a, b))
        found.sort(reverse=True)
        out = []
        for length, a, b in found[:top]:
            best, label = 0.0, "host between spans"
            for sp in spans:
                s = t0 + sp["ts_us"] / 1e6
                e = s + sp["dur_us"] / 1e6
                over = min(b, e) - max(a, s)
                if over > best:
                    best, label = over, sp["name"]
            out.append((label, length))
        return out


def profile(fn: Callable[[], None], device) -> Trace:
    """Run ``fn`` under the profiler (device activity only) and return its
    device operations on the host's clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    marker = torch.zeros(1, device=device)
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t_marker = time.perf_counter()
        marker.fill_(1.0)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        host_s = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device operation")
    events.sort(key=lambda e: e.time_range.start)
    first = events[0]
    offset_us = first.time_range.start - t_marker * 1e6
    ops = [(e.name, (e.time_range.start - offset_us) / 1e6,
            (e.time_range.end - offset_us) / 1e6) for e in events[1:]]
    if not ops:
        raise RuntimeError("the profiler recorded only the marker")
    return Trace(ops, host_s)


def top_ops(trace: Trace, top: int = 10) -> List[Tuple[str, float]]:
    by = trace.seconds_by(short_name)
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def family_seconds(trace: Trace) -> Dict[str, float]:
    return trace.seconds_by(family)
