"""Tokens of every step of the window over the window's seconds; a step
ends in the ``.item()`` of its metrics."""

from cardbench.readers import rate


def read(ctx):
    return rate(ctx)
