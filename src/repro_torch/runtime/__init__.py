"""Runtime over ranks: the port of ``repro.runtime``.

``ranks`` starts and joins the processes (one a shard) and holds the
collective calls; ``collectives`` has the slow-tier reductions
(``int8_psum``, ``hierarchical_psum``), ``elastic`` the mesh after a loss
of ranks and the resharding of a state onto it, ``pipeline`` a GPipe
forward over a ``"pipe"`` mesh dim.
"""

from repro_torch.runtime.elastic import elastic_mesh, reshard_state
from repro_torch.runtime.collectives import int8_psum, hierarchical_psum

__all__ = ["elastic_mesh", "reshard_state", "int8_psum", "hierarchical_psum"]
