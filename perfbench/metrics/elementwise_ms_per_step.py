"""Device milliseconds a step of the operations outside the port's own
kernels, cuBLAS's matrix products and PyTorch's index kernels: PyTorch's
element-wise, reduction and copy kernels (the "other" family of the
program's ``launch/profile.py``), in the profiled steps."""

from perfbench.lib import device_trace as DT


def read(ctx):
    if ctx.trace is None or not ctx.profiled_steps:
        return None
    other = DT.family_seconds(ctx.trace).get("other", 0.0)
    return other * 1e3 / ctx.profiled_steps
