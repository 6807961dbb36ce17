"""Device events of calls on the card, read from ``torch.profiler``.

Used by ``chip_smoke.py`` and ``tools/sort_variant_times.py`` to split a
call's device time by kernel.  On the H100 the profiler drops the first
device events of a session, more the longer the process has run (none in
a fresh process, a few once it has run a minute, idle or not).  So a
session starts with a run of spin kernels that may be dropped, and every
traced call follows a spin kernel of its own: the call's events are those
between its marker and the next.
"""

from __future__ import annotations

import torch

_SACRIFICED = 16  # spin kernels at the start of a session, more than it drops
_SPIN_CYCLES = 1000


def call_events(fn, calls: int) -> "list[list[tuple[str, float]]] | None":
    """``(kernel or copy name, device ms)`` of every device event of each of
    ``calls`` calls of ``fn``, in order, one list a call; None if the
    profiler showed fewer markers than calls (it saw no device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(_SACRIFICED):
            torch.cuda._sleep(_SPIN_CYCLES)
        for _ in range(calls):
            torch.cuda._sleep(_SPIN_CYCLES)
            fn()
            torch.cuda.synchronize()
    events = sorted(
        (e.time_range.start, e.name, e.device_time_total / 1e3)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request"
    )
    marks = [i for i, (_, name, _) in enumerate(events) if "spin_kernel" in name]
    if len(marks) < calls:
        return None
    marks = marks[-calls:] + [len(events)]
    return [[(name, ms) for _, name, ms in events[a + 1 : b]] for a, b in zip(marks, marks[1:])]
