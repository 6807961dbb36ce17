"""Device ms a traced step spent in the program's span ``train.optimizer``:
the schedule, AdamW's update of every weight and moment."""

from cardbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "train.optimizer", device=True)
