"""Device events of calls on the card, read from ``torch.profiler``.

A frozen copy of ``repro_torch.devtrace`` that also keeps each event's
start.  On the H100 the profiler drops the first device events of a
session, more the longer the process has run.  So a session starts with a
run of spin kernels that may be dropped, and every traced call follows a
spin kernel of its own: the call's events are those between its marker
and the next.  Event times are given from the end of the call's marker,
which the host launched just before the call began.
"""

from __future__ import annotations

import torch

_SACRIFICED = 16  # spin kernels at the start of a session, more than it drops
_SPIN_CYCLES = 1000


class Session:
    """Profile calls one at a time: ``with Session() as s: s.call(fn)``,
    then ``s.events()``."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(_SACRIFICED):
            torch.cuda._sleep(_SPIN_CYCLES)
        self.calls = 0
        return self

    def call(self, fn):
        """Run ``fn()`` behind a marker and wait for the card."""
        torch.cuda._sleep(_SPIN_CYCLES)
        self.calls += 1
        out = fn()
        torch.cuda.synchronize()
        return out

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def events(self) -> "list[list[tuple[str, float, float]]] | None":
        """``(name, start ms, device ms)`` of every device event of each
        call, in order, the start taken from the end of the call's marker;
        None if the profiler showed fewer markers than calls."""
        from torch.autograd import DeviceType

        evs = sorted(
            (e.time_range.start, e.name, e.device_time_total / 1e3)
            for e in self._prof.events()
            if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request"
        )
        marks = [i for i, (_, name, _) in enumerate(evs) if "spin_kernel" in name]
        if len(marks) < self.calls:
            return None
        marks = marks[len(marks) - self.calls :] + [len(evs)]
        out = []
        for a, b in zip(marks, marks[1:]):
            t0 = evs[a][0] / 1e3 + evs[a][2]  # the marker's end, ms
            out.append([(name, start / 1e3 - t0, ms) for start, name, ms in evs[a + 1 : b]])
        return out
