"""The flash attention kernels' share of their roofline, in %: the least
time of the forward and both backward kernels at the cell's shapes (the
frozen ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv`` counts, bf16,
989 TFLOP/s, 3.35 TB/s), every layer of every profiled step, over the
device time of the kernels whose names hold these patterns."""

from perfbench.lib import cost as C

PATTERNS = ("flash_fwd", "flash_bwd")


def read(ctx):
    shapes = getattr(ctx.fam, "attention_shapes", None)
    if ctx.trace is None or shapes is None:
        return None
    device_s = ctx.trace.matching(PATTERNS)
    if device_s <= 0:
        return None
    least = 0.0
    for kw in shapes(ctx.conf, ctx.mix["batch"] // ctx.halves,
                     ctx.mix["seq"]) * ctx.halves:
        for fn in (C.flash_fwd, C.flash_bwd_dq, C.flash_bwd_dkv):
            least += C.least_s(fn(**kw, itemsize=2))
    return 100.0 * least * ctx.profiled_steps / device_s
