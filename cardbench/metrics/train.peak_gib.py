"""``torch.cuda.max_memory_allocated()`` over the window, reset after set-up."""


def read(ctx):
    return ctx["window_peak_bytes"] / 2**30 if ctx["window_peak_bytes"] else None
