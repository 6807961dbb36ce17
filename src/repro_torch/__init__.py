"""repro_torch: the OTIS Hyper Hexa-Cell parallel Quick Sort on PyTorch and CUDA.

A port of the JAX package ``repro`` (which stays the reference) to one
NVIDIA H100.  It imports neither jax nor anything of ``repro``.  Layers:
``core`` (topology, partition, the simulated and host sorts, the
autotuned ``SortEngine``), ``kernels`` (hand-written CUDA kernels for
Hopper, each beside its plain torch version), ``data`` (input
generators) and ``dtypes`` (the unsigned → signed key boundary).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from repro_torch.core import SortEngine

__version__ = "0.1.0"

__all__ = ["SortEngine"]
