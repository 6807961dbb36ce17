"""Set-up: process start to the first timed call (imports, the card's
start, the build on a checkout's first run, inputs and weights, warm-up)."""


def read(ctx):
    return ctx["setup_s"]
