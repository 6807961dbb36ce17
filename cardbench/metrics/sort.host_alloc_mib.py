"""MiB of fresh host buffers a request makes (the program's counter
``engine.host_alloc_bytes``: the padded keys, the answer)."""

import statistics

from cardbench.program_spans import counter


def read(ctx):
    per = counter(ctx, "engine.host_alloc_bytes")
    return statistics.fmean(per) / 2**20 if per else None
