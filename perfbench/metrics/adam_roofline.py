"""Adam's share of its roofline, in %: the least time of ``adam_sumsq`` and
``adam_update`` over every parameter (the frozen byte and operation
counts; fp32 on the CUDA cores, 3.35 TB/s), a step, over the device time of
those kernels in the profiled steps."""

from perfbench.lib import cost as C

PATTERNS = ("adam_update_kernel", "sumsq_")


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.matching(PATTERNS)
    if device_s <= 0:
        return None
    n = ctx.param_numel
    least = C.least_s(C.adam_sumsq(n), C.PEAK_FP32_FLOPS) \
        + C.least_s(C.adam_update(n), C.PEAK_FP32_FLOPS)
    return 100.0 * least * ctx.profiled_steps / device_s
