"""Device ms a traced step spent in the program's span ``train.forward``:
the model's forward and the loss."""

from cardbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "train.forward", device=True)
