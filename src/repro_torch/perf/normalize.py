"""Machine normalization: judge perf on roofline multiples, not seconds
(DESIGN.md §9).

The port's copy of ``repro_torch.perf.normalize``; ``host_hw(device)``
calibrates the device the cases run on (the card by default).

A raw wall-clock baseline is a property of one machine; re-run it on a
faster host and every case "improves", on a slower one everything
"regresses".  Each :class:`~repro_torch.perf.schema.PerfCase` therefore carries
a :class:`Workload` — the bytes it must move and the useful FLOPs it must
execute per call — and the judged metric is

    norm_ratio = measured_s / roofline_s(workload, calibrated host peaks)

i.e. "how many multiples of this machine's roofline lower bound did the
call take".  Rescale every peak by k (a different machine) and both the
fresh value and a reference recorded under the same normalization scale by
the same k — the regression judgment is invariant, which is what makes a
committed ``BENCH_*.json`` portable.  ``pct_of_roofline`` (the inverse, as
a percentage) rides along for human consumption, the berkeley-ERT way.

A case without a workload model (e.g. the netsim event loop, whose cost is
events, not bytes) falls back to raw seconds; its baseline is honest but
machine-local, and the guard marks it so.
"""

from __future__ import annotations

import dataclasses

from repro_torch.roofline.analysis import bound_time_s
from repro_torch.roofline.hw import HW, calibrate_host


@dataclasses.dataclass(frozen=True)
class Workload:
    """Per-call work model: bytes moved and useful FLOPs executed.

    ``bytes_moved`` is the honest *lower bound* (inputs read once +
    outputs written once); a multi-pass algorithm runs at a small
    percentage of this roofline, which is fine — the guard judges ratios
    against a reference, not absolute efficiency.
    """

    bytes_moved: float
    flops: float = 0.0

    def as_dict(self) -> dict:
        return {"bytes_moved": self.bytes_moved, "flops": self.flops}


def roofline_s(workload: Workload, hw: HW) -> float:
    """Roofline lower bound for one call of this workload on ``hw``."""
    t = bound_time_s(flops=workload.flops, bytes_moved=workload.bytes_moved, hw=hw)
    if t <= 0.0:
        raise ValueError(f"workload {workload} has no positive roofline time")
    return t


def normalize(measured_s: float, workload: "Workload | None", hw: HW) -> dict:
    """The normalization record stored with every measurement.

    With a workload: ``norm_ratio`` (measured / roofline, ≥ ~1 ideally)
    and ``pct_of_roofline`` (its inverse × 100).  Without one: raw-seconds
    fallback — ``norm_ratio`` is the measured time itself and
    ``pct_of_roofline`` is None, flagged via ``normalized=False``.
    """
    if workload is None:
        return {
            "normalized": False,
            "roofline_s": None,
            "norm_ratio": measured_s,
            "pct_of_roofline": None,
        }
    ideal = roofline_s(workload, hw)
    return {
        "normalized": True,
        "roofline_s": ideal,
        "norm_ratio": measured_s / ideal,
        "pct_of_roofline": 100.0 * ideal / measured_s if measured_s > 0 else None,
    }


def host_hw(device="cuda") -> HW:
    """The calibrated peaks of ``device`` (cached per process): the card
    by default, the host for ``device="cpu"``."""
    return calibrate_host(device=device)
