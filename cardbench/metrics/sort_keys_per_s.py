"""Keys of every request of the window over the window's seconds."""

from cardbench.readers import rate


def read(ctx):
    return rate(ctx)
