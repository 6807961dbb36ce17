"""repro_torch.roofline — hardware records, the card's calibration and the
roofline arithmetic (the port's copy of what ``repro.perf`` needs of
``repro.roofline``)."""

from repro_torch.roofline.hw import H100, HW, V5E

__all__ = ["H100", "HW", "V5E"]
