"""repro_torch.roofline — hardware records, the card's calibration, the
roofline arithmetic, the trace-based roofline of a dry-run step
(``analysis``) and the report over dry-run cells (``report``,
``gen_experiments``): the port's copy of ``repro.roofline``."""

from repro_torch.roofline.hw import H100, HW, V5E

__all__ = ["H100", "HW", "V5E"]
