"""Model operations of a step (``work.train_step_flops``) over the step's
time at the bf16 peak, over the window's untraced steps."""

from cardbench import work


def read(ctx):
    steps = ctx["calls"][ctx["n_traced"]:]
    if not steps:
        return None
    seconds = sum(b - a for a, b, _ in steps)
    flops = work.train_step_flops(ctx["config"], ctx["traffic"]) * len(steps)
    return 100.0 * flops / (seconds * ctx["hw"].BF16_FLOPS)
