"""Input generators for the port (a copy of ``repro.data.distributions``)."""

from repro_torch.data.distributions import (
    ALL_DISTRIBUTIONS,
    DISTRIBUTIONS,
    PAPER_SIZES_MB,
    elements_for_mb,
    make_array,
)

__all__ = [
    "ALL_DISTRIBUTIONS",
    "DISTRIBUTIONS",
    "PAPER_SIZES_MB",
    "elements_for_mb",
    "make_array",
]
