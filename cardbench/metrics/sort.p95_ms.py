"""95th percentile of a traced run's request times, over the requests after
the traced ones: the host clock from the call to ``SortEngine.sort`` until
its numpy answer returns.  One closed-loop client keeps the engine at its
capacity, where the tail swings with the host's memory speed, so it is
read beside ``sort_keys_per_s`` and bounds nothing."""

from cardbench.readers import tail_ms


def read(ctx):
    return tail_ms(dict(ctx, calls=ctx["calls"][ctx["n_traced"]:]), 95)
