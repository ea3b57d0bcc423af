"""The device's idle share over the profiled steps, in %: 1 - busy / span,
busy the union of the device operations' intervals and span the first
operation's start to the last one's end (``launch/profile.py``'s
arithmetic, with overlapping streams counted once)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.span_s)
