"""Mean host milliseconds of the program's ``recovery`` spans
(``recovery/base.py``) over the timed window's failures: the strategy's
handler on the host, which enqueues the merge or the copy and reads the
recovery error back."""


def read(ctx):
    spans = [s for s in ctx.window_spans if s["name"] == "recovery"]
    if not spans:
        return None
    return sum(s["dur_us"] for s in spans) / 1e3 / len(spans)
