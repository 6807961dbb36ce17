"""Device ms a traced step spent in the program's span ``train.backward``:
``torch.autograd.grad`` and the gradients' layout."""

from cardbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "train.backward", device=True)
