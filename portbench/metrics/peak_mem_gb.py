"""Peak device memory over set-up and window: ``torch.cuda.
max_memory_allocated()`` when the window closes, of the fullest card the
run uses, in 1e9 bytes."""


def read(ctx):
    if ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / 1e9
