"""The SSD scan kernels' share of their roofline, in %: the least time of
the scan's forward and backward at the cell's shapes (the frozen
``ssd_fwd``, ``ssd_bwd`` counts, bf16, 989 TFLOP/s, 3.35 TB/s), every
layer and batch half of every profiled step, over the device time of the
kernels whose names hold these patterns."""

from perfbench.lib import cost as C

PATTERNS = ("ssd_scan", "ssd_bwd_")


def read(ctx):
    shapes = getattr(ctx.fam, "scan_shapes", None)
    if ctx.trace is None or shapes is None:
        return None
    device_s = ctx.trace.matching(PATTERNS)
    if device_s <= 0:
        return None
    least = 0.0
    for kw in shapes(ctx.conf, ctx.mix["batch"], ctx.mix["seq"], ctx.halves):
        least += C.least_s(C.ssd_fwd(**kw)) + C.least_s(C.ssd_bwd(**kw))
    return 100.0 * least * ctx.profiled_steps / device_s
