"""The benchmark's frozen yardstick against counts worked by hand: the
kernels' bytes and operations, the device-trace arithmetic, and the
metrics that read them."""
import math
from types import SimpleNamespace

import pytest

from perfbench.tests import _tiny
from perfbench.lib import cost as C
from perfbench.lib import device_trace as DT
from perfbench.lib import registry


def test_visible_pairs():
    assert C.visible_pairs(4, True, 0) == 1 + 2 + 3 + 4
    assert C.visible_pairs(4, True, 2) == 1 + 2 + 2 + 2
    assert C.visible_pairs(3, False, 0, sk=5) == 15
    # a window as long as the sequence masks nothing more than causal
    assert C.visible_pairs(4096, True, 4096) == 4096 * 4097 // 2


def test_flash_counts():
    kw = dict(b=1, hq=2, hkv=1, s=4, sk=4, d=8, itemsize=2, causal=True,
              window=0)
    # q 1*2*4*8*2 = 128 B, k or v 64 B, lse 1*2*4*4 = 32 B; 10 pairs a head
    assert C.flash_fwd(**kw) == (2 * 128 + 2 * 64 + 32, 4 * 2 * 8 * 10)
    assert C.flash_bwd_dq(**kw) == (3 * 128 + 2 * 64 + 2 * 32,
                                    6 * 8 * 2 * 10)
    assert C.flash_bwd_dkv(**kw) == (2 * 128 + 4 * 64 + 2 * 32,
                                     8 * 8 * 2 * 10)


def test_ssd_counts():
    kw = dict(b=1, t=8, h=2, p=4, g=1, n=2, chunk=4)
    # x and y 2*128 B, a 64 B, B and C 2*32 B, the state 2*4*2*4 = 64 B
    assert C.ssd_fwd(**kw) == (256 + 64 + 64 + 64,
                               1 * 2 * 2 * (64 + 128 + 128))
    assert C.ssd_bwd(**kw) == (384 + 128 + 128,
                               1 * 2 * 2 * 2 * (96 + 128 + 160))


def test_element_wise_counts_and_the_least_time():
    assert C.adam_sumsq(10) == (40, 20)
    assert C.adam_update(10) == (280, 150)
    assert C.stage_merge(10) == (120, 30)
    assert C.least_s((3.35e12, 989e12)) == pytest.approx(1.0)
    assert C.least_s((0, 67e12), C.PEAK_FP32_FLOPS) == pytest.approx(1.0)
    assert C.least_s((6.7e12, 1.0)) == pytest.approx(2.0)


@pytest.mark.parametrize("name,family", [
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT", "matmul"),
    ("flash_bwd_dq_bf16_kernel<120>", "flash_attention"),
    ("ssd_bwd_bf16_kernel<128>", "ssd_scan_bwd"),
    ("ssd_scan_bf16_kernel<128>", "ssd_scan"),
    ("adam_update_kernel", "adam"),
    ("stage_merge_kernel", "stage_merge"),
    ("void at::native::indexSelectLargeIndex<float>", "index"),
    ("void at::native::vectorized_elementwise_kernel<4>", "other")])
def test_families(name, family):
    assert DT.family(name) == family


def _trace():
    return DT.Trace([("nvjet_gemm", 0.0, 1.0),
                     ("flash_fwd_bf16_kernel<120>", 0.5, 2.0),
                     ("void at::native::elementwise_kernel", 3.0, 4.0)],
                    host_s=4.5)


def test_busy_span_and_gaps():
    t = _trace()
    assert t.merged() == [(0.0, 2.0), (3.0, 4.0)]
    assert t.busy_s == pytest.approx(3.0)
    assert t.span_s == pytest.approx(4.0)
    spans = [{"name": "window_dispatch", "ts_us": 0.0, "dur_us": 2.2e6},
             {"name": "recovery", "ts_us": 2.2e6, "dur_us": 0.6e6}]
    assert t.gaps(spans, 0.0) == [("recovery", pytest.approx(1.0))]
    assert t.gaps([], 0.0) == [("host between spans", pytest.approx(1.0))]
    assert DT.family_seconds(t) == {"matmul": 1.0, "flash_attention": 1.5,
                                    "other": 1.0}


def _ctx(**kw):
    base = dict(conf=_tiny.conf("dense"), mix=_tiny.mix("dense", 2, 4),
                fam=registry.reference_module(registry.ROOT, "dense"),
                halves=1, window_s=2.0, window_steps=4, window_spans=[],
                trace=_trace(), traced_spans=[], origin=0.0,
                profiled_steps=2, peak_reserved_bytes=2 ** 31,
                param_numel=1000)
    base.update(kw)
    return SimpleNamespace(**base)


def metric(name):
    return registry.metric_module(registry.ROOT, name)


def test_trace_metrics_by_hand():
    ctx = _ctx()
    assert metric("device_idle_share").read(ctx) == pytest.approx(25.0)
    assert metric("elementwise_ms_per_step").read(ctx) == pytest.approx(500)
    assert metric("peak_reserved_gib").read(ctx) == pytest.approx(2.0)
    # the flash kernels: 1.5 s for 2 steps of 4 layers at b 2, s 4, 4/2
    # heads of 16; each call bound by its bytes
    per_call = sum(C.least_s(f(b=2, hq=4, hkv=2, s=4, sk=4, d=16,
                               itemsize=2, causal=True, window=4096))
                   for f in (C.flash_fwd, C.flash_bwd_dq, C.flash_bwd_dkv))
    assert metric("attention_roofline").read(ctx) == pytest.approx(
        100 * per_call * 4 * 2 / 1.5)
    # no adam kernel in the trace: nothing to read
    assert metric("adam_roofline").read(ctx) is None
    assert metric("ssd_roofline").read(ctx) is None
    assert metric("attention_roofline").read(_ctx(trace=None)) is None


def test_span_metrics_by_hand():
    spans = [{"name": "window_dispatch", "ts_us": 0, "dur_us": 8000.0,
              "args": {"k": 8}},
             {"name": "window_dispatch", "ts_us": 0, "dur_us": 1000.0,
              "args": {"k": 1}},
             {"name": "recovery", "ts_us": 0, "dur_us": 4000.0, "args": {}},
             {"name": "recovery", "ts_us": 0, "dur_us": 2000.0, "args": {}}]
    ctx = _ctx(window_spans=spans)
    assert metric("window_steps_mean").read(ctx) == pytest.approx(4.5)
    assert metric("recovery_ms").read(ctx) == pytest.approx(3.0)
    assert metric("recovery_ms").read(_ctx()) is None


def test_dispatch_idle_by_hand():
    # the card runs 0-2 s and 3-4 s; the host dispatches 0-2.5 s (one
    # step) and 2.5-5 s (one step, clipped to the trace's end at 4 s)
    spans = [{"name": "window_dispatch", "ts_us": 0.0, "dur_us": 2.5e6,
              "args": {"k": 1}},
             {"name": "window_dispatch", "ts_us": 2.5e6, "dur_us": 2.5e6,
              "args": {"k": 1}},
             {"name": "recovery", "ts_us": 2.0e6, "dur_us": 1.0e6,
              "args": {}}]
    t = _trace()
    assert t.idle_within(0.0, 2.5) == pytest.approx(0.5)
    assert t.idle_within(2.5, 5.0) == pytest.approx(0.5)
    assert t.idle_within(-1.0, 0.0) == 0.0
    ctx = _ctx(traced_spans=spans, origin=0.0)
    assert metric("dispatch_ms_per_step").read(ctx) == pytest.approx(500.0)
    # the spans' recorder clock starts 1 s after the host's origin
    ctx = _ctx(traced_spans=spans[:1], origin=1.0)
    assert metric("dispatch_ms_per_step").read(ctx) == pytest.approx(1000.0)
    assert metric("dispatch_ms_per_step").read(_ctx()) is None
    assert metric("dispatch_ms_per_step").read(
        _ctx(trace=None, traced_spans=spans)) is None


def test_mfu_by_hand():
    ctx = _ctx()
    d, hq, hkv, hd, ff, v = 64, 4, 2, 16, 128, 256
    params = 4 * (2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * ff) + d * v
    tokens = 2 * 4
    attn = 4 * 3 * (4 * 2 * hq * hd * 10)      # 10 causal pairs of s 4
    flops = 6 * params * tokens + attn
    assert metric("mfu").read(ctx) == pytest.approx(
        100 * flops * 4 / (2.0 * 989e12))
    assert math.isclose(
        registry.reference_module(registry.ROOT, "dense").matmul_params(
            ctx.conf), params)
