"""Host ms a request spent in ``SortEngine.stats`` and ``plan`` (the
benchmark's span ``plan`` around them, traced requests)."""

from cardbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "plan")
