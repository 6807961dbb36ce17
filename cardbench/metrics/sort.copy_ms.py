"""Device ms a request of host-to-card and card-to-host copies."""

import statistics

from cardbench.readers import device_ms, is_copy


def read(ctx):
    per = device_ms(ctx, is_copy)
    return statistics.fmean(per) if per else None
