"""The least time of a request's device sort (each key read once and
written once at the HBM peak) over its device time outside the copies."""

from cardbench import work
from cardbench.readers import device_ms, is_copy


def read(ctx):
    per = device_ms(ctx, lambda n: not is_copy(n))
    if not per or not sum(per):
        return None
    bound_ms = sum(work.sort_bytes(rec["work"], ctx["traffic"]["dtype"]) for rec in ctx["traced"])
    bound_ms /= ctx["hw"].HBM_BYTES_S / 1e3
    return 100.0 * bound_ms / sum(per)
