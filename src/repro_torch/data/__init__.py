"""Input generators for the port: a copy of ``repro.data.distributions``
(sort inputs) and of ``repro.data.pipeline`` (synthetic LM batches)."""

from repro_torch.data.distributions import (
    ALL_DISTRIBUTIONS,
    DISTRIBUTIONS,
    PAPER_SIZES_MB,
    elements_for_mb,
    make_array,
)
from repro_torch.data.pipeline import SyntheticLMData

__all__ = [
    "ALL_DISTRIBUTIONS",
    "DISTRIBUTIONS",
    "PAPER_SIZES_MB",
    "SyntheticLMData",
    "elements_for_mb",
    "make_array",
]
