"""Share of the traced steps' wall time in which no device operation ran."""

from cardbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
