"""``torch.cuda.max_memory_reserved()`` over set-up and the timed window, in
GiB: the allocator's blocks, which hold a CUDA graph's pool."""


def read(ctx):
    if not ctx.peak_reserved_bytes:
        return None
    return ctx.peak_reserved_bytes / 2 ** 30
