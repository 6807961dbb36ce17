"""Host ms a request spent in the program's span ``engine.stage``: the
padded key buffer made and filled, the keys mapped (``dtypes.to_keys``)."""

from cardbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "engine.stage")
