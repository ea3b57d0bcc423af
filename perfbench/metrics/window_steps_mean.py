"""Steps a dispatch: the mean ``k`` of the program's ``window_dispatch``
spans in the timed window (a count: how far failures cut the fused
windows)."""


def read(ctx):
    ks = [int(s["args"]["k"]) for s in ctx.window_spans
          if s["name"] == "window_dispatch"]
    return sum(ks) / len(ks) if ks else None
