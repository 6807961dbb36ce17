"""Share of the pinned host blocks a request took that the pool already
held: 100 · (1 − Σ ``engine.pinned_new_bytes`` / Σ ``engine.pinned_bytes``)
over the traced requests (the program's counters, counted where
``engine.stage`` and ``engine.d2h`` take a block)."""

from cardbench.program_spans import counter


def read(ctx):
    taken = counter(ctx, "engine.pinned_bytes")
    new = counter(ctx, "engine.pinned_new_bytes")
    if not taken or new is None or not sum(taken):
        return None
    return 100.0 * (1.0 - sum(new) / sum(taken))
