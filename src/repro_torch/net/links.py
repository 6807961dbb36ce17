"""Per-link-class timing parameters for the OHHC link simulator.

The paper's conclusion laments that "the difference in the speed of the
electrical and optical connections ... was not taken into consideration";
``repro_torch.core.ohhc_sort.LinkModel`` models it analytically (one
bandwidth/latency pair per class, used by the closed-form round model).
This module is the *simulator-grade* version (DESIGN.md §6): each link
class carries the full LogP-style triple

* ``startup_us``  — per-message software/SerDes overhead paid at the sender
  before the first byte moves (the classic ``t_s``),
* ``latency_us``  — wire propagation delay (``t_l``), paid once per hop,
* ``gbps``        — link bandwidth in GB/s (``1/t_b`` per byte).

so a hop carrying ``m`` bytes costs ``startup + latency + m/bw`` and a
store-and-forward route of ``h`` hops costs the sum over its hops — the
Theorem-6 ``t·(2·d_h+3)`` structure with the constants made explicit.

The port's copy of ``repro.net.links``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.ohhc_sort import LinkModel as CoreLinkModel

ELECTRICAL = "electrical"
OPTICAL = "optical"


@dataclasses.dataclass(frozen=True)
class LinkClass:
    """Timing of one link class (electrical or optical)."""

    startup_us: float
    latency_us: float
    gbps: float  # GB/s; float('inf') disables the bandwidth term

    def hop_time_s(self, nbytes: float) -> float:
        t = (self.startup_us + self.latency_us) * 1e-6
        if self.gbps != float("inf"):
            t += nbytes / (self.gbps * 1e9)
        return t


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Electronic vs optical link asymmetry (paper §1.3).

    Defaults mirror ``repro_torch.core.ohhc_sort.LinkModel`` (the reference's
    modelled ICI vs inter-pod link constants) so simulated and analytic times are directly
    comparable: same 1 µs per-message overhead, 50 vs 25 GB/s.
    """

    electrical: LinkClass = LinkClass(startup_us=1.0, latency_us=0.0, gbps=50.0)
    optical: LinkClass = LinkClass(startup_us=1.0, latency_us=0.0, gbps=25.0)

    def link_class(self, kind: str) -> LinkClass:
        if kind == ELECTRICAL:
            return self.electrical
        if kind == OPTICAL:
            return self.optical
        raise ValueError(f"unknown link kind {kind!r}")

    def hop_time_s(self, kind: str, nbytes: float) -> float:
        return self.link_class(kind).hop_time_s(nbytes)

    # ---- constructors -------------------------------------------------------
    @classmethod
    def unit(cls, step_us: float = 1.0) -> "LinkModel":
        """Byte-agnostic model: every hop costs exactly ``step_us``.

        Under this model the simulated gather time divided by ``step_us``
        *is* the critical-path hop count, which is how the simulator
        validates Theorem 3 / Theorem 6 round accounting against a
        measured timeline rather than a formula.
        """
        u = LinkClass(startup_us=step_us, latency_us=0.0, gbps=float("inf"))
        return cls(electrical=u, optical=u)

    @classmethod
    def from_core(cls, core: CoreLinkModel) -> "LinkModel":
        """Bridge from the analytic cost model's parameters."""
        return cls(
            electrical=LinkClass(core.alpha_us, 0.0, core.electrical_gbps),
            optical=LinkClass(core.alpha_us, 0.0, core.optical_gbps),
        )

    def to_core(self) -> CoreLinkModel:
        """Project onto the analytic model (drops the latency split)."""
        return CoreLinkModel(
            electrical_gbps=self.electrical.gbps,
            optical_gbps=self.optical.gbps,
            alpha_us=self.electrical.startup_us + self.electrical.latency_us,
        )
