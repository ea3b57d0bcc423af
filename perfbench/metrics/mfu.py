"""The whole step's share of the card's bf16 peak, in %: model operations
of the timed window's steps over (window seconds x 989 TFLOP/s).  A step's
model operations are 6 x the parameters that multiply each token (the
head counted, the embedding lookup not) x its tokens, plus the attention's
or the scan's own: 3 x the frozen forward count (a backward of twice the
forward; the backward kernels' recomputation is not counted)."""

from perfbench.lib import cost as C


def step_flops(ctx) -> float:
    tokens = ctx.mix["batch"] * ctx.mix["seq"]
    flops = 6.0 * ctx.fam.matmul_params(ctx.conf) * tokens
    attn = getattr(ctx.fam, "attention_shapes", None)
    if attn is not None:
        for kw in attn(ctx.conf, ctx.mix["batch"] // ctx.halves,
                       ctx.mix["seq"]) * ctx.halves:
            flops += 3.0 * C.flash_fwd(**kw, itemsize=2)[1]
    scan = getattr(ctx.fam, "scan_shapes", None)
    if scan is not None:
        for kw in scan(ctx.conf, ctx.mix["batch"], ctx.mix["seq"],
                       ctx.halves):
            flops += 3.0 * C.ssd_fwd(**kw)[1]
    return flops


def read(ctx):
    if not ctx.window_s:
        return None
    return 100.0 * step_flops(ctx) * ctx.window_steps \
        / (ctx.window_s * C.PEAK_BF16_FLOPS)
