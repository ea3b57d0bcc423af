"""Device milliseconds a step in which the card sat idle inside the
program's ``window_dispatch`` spans (``core/trainer.py``), over the traced
steps: the gaps between kernels while a step is dispatched, which the
host's launches set in the eager loop and the graph's own launches in a
replayed window.  The spans' own length is no measure of it, since the
eager loop's span holds the whole step (it reads the learning-rate scale
back) and a fused window's waits on the card too; the device's busy time
inside them is left out."""


def read(ctx):
    if ctx.trace is None:
        return None
    spans = [s for s in ctx.traced_spans if s["name"] == "window_dispatch"]
    steps = sum(int(s["args"]["k"]) for s in spans)
    if not steps:
        return None
    idle = 0.0
    for s in spans:
        a = ctx.origin + s["ts_us"] / 1e6
        idle += ctx.trace.idle_within(a, a + s["dur_us"] / 1e6)
    return 1e3 * idle / steps
