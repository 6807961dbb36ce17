"""OTIS Hyper Hexa-Cell (OHHC) interconnection topology.

Faithful construction of the interconnect from the paper (§1.4–1.5):

* A **1-dimensional HHC** is 6 processors arranged as two fully-connected
  triangles, plus one cross edge per node pairing the triangles
  (Fig 1.1).  The algorithm in §3.2(a) uses the pairing
  ``5↔0, 3↔1, 4↔2`` (node 5 sends *directly* to node 0; 3→1, 4→2), so we
  adopt exactly that pairing for the cross edges.

* A **d_h-dimensional HHC** replaces every vertex of a (d_h−1)-dimensional
  hypercube with a 1-D HHC (Fig 1.2).  It therefore contains
  ``2**(d_h−1)`` HHC cells ("HHC groups") of 6 nodes each, i.e.
  ``P(d_h) = 6·2**(d_h−1)`` processors.  Hypercube edges connect *every*
  node of a cell to the same-position node of the cell whose index differs
  in one bit (the standard HHC construction: uniform degree
  ``3 + (d_h−1)``, HHC diameter ``d_h + 1``, and hence OHHC diameter
  ``2·d_h + 3 = 2·(d_h+1) + 1`` — the OTIS rule ``2·d(factor) + 1``).
  The accumulation algorithm in Fig 3.2 only ever *uses* the head-to-head
  links (node 0 of each cell), which are a subset of this wiring.

* An **OHHC** is ``G`` HHC groups joined by optical OTIS links:
  node ``x`` of group ``y`` ↔ node ``y`` of group ``x`` (§3.2(c)).
  Two variants (Table 1.1):  ``G = P`` ("full") and ``G = P/2`` ("half").

Table 1.1 reproduction::

    d_h   G=P  (groups, procs)   G=P/2 (groups, procs)
    1     (6,   36)              (3,   18)
    2     (12,  144)             (6,   72)
    3     (24,  576)             (12,  288)
    4     (48,  2304)            (24,  1152)

Addressing: a processor is ``(group, local)`` with
``local = 6*hhc_group + hhc_node``; its *global id* is
``group * P + local``.  Chunk/bucket ``k`` of the value-range partition is
owned by global id ``k`` so that gathering in global-id order yields the
sorted array (§3.1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

HHC_SIZE = 6

# Cross edges pairing the two triangles, exactly as used by the
# accumulation rules of Fig 3.1 (5→0, 3→1, 4→2).
_CROSS_PAIRS = ((0, 5), (1, 3), (2, 4))
# Each triangle is fully connected.
_TRIANGLES = ((0, 1, 2), (3, 4, 5))


def hhc_cell_edges() -> list[tuple[int, int]]:
    """Undirected edges of a single 1-D HHC cell (Fig 1.1): 6 triangle + 3 cross."""
    edges = []
    for tri in _TRIANGLES:
        a, b, c = tri
        edges += [(a, b), (a, c), (b, c)]
    edges += list(_CROSS_PAIRS)
    return edges


@dataclasses.dataclass(frozen=True)
class OHHCTopology:
    """An OHHC instance: ``d_h`` ∈ {1,2,3,4,...}, ``variant`` ∈ {'full','half'}.

    ``variant='full'``  → G = P   (paper's "full group" OHHC)
    ``variant='half'``  → G = P/2 (paper's "half group" OHHC)
    """

    d_h: int
    variant: str = "full"

    def __post_init__(self):
        if self.d_h < 1:
            raise ValueError(f"d_h must be >= 1, got {self.d_h}")
        if self.variant not in ("full", "half"):
            raise ValueError(f"variant must be 'full' or 'half', got {self.variant!r}")

    # ---- sizes (Table 1.1) -------------------------------------------------
    @property
    def num_hhc_cells(self) -> int:
        """HHC cells per group = hypercube vertices = 2**(d_h-1)."""
        return 1 << (self.d_h - 1)

    @property
    def procs_per_group(self) -> int:
        """P = 6 · 2**(d_h−1)."""
        return HHC_SIZE * self.num_hhc_cells

    @property
    def num_groups(self) -> int:
        """G = P (full) or P/2 (half)."""
        p = self.procs_per_group
        return p if self.variant == "full" else p // 2

    @property
    def total_procs(self) -> int:
        return self.num_groups * self.procs_per_group

    # ---- addressing ---------------------------------------------------------
    def global_id(self, group: int, local: int) -> int:
        return group * self.procs_per_group + local

    def addr(self, gid: int) -> tuple[int, int]:
        """global id → (group, local)."""
        return divmod(gid, self.procs_per_group)

    @staticmethod
    def split_local(local: int) -> tuple[int, int]:
        """local → (hhc_cell, hhc_node)."""
        return divmod(local, HHC_SIZE)

    # ---- links --------------------------------------------------------------
    def electrical_neighbors(self, local: int) -> list[int]:
        """Intra-group neighbours of a local index (triangles + cross + hypercube)."""
        cell, node = self.split_local(local)
        out = []
        # triangle edges
        for tri in _TRIANGLES:
            if node in tri:
                out += [cell * HHC_SIZE + m for m in tri if m != node]
        # cross edge
        for a, b in _CROSS_PAIRS:
            if node == a:
                out.append(cell * HHC_SIZE + b)
            elif node == b:
                out.append(cell * HHC_SIZE + a)
        # hypercube edges: every node links to its same-position counterpart
        # in each bit-adjacent cell (uniform degree 3 + d_h − 1)
        for bit in range(self.d_h - 1):
            out.append((cell ^ (1 << bit)) * HHC_SIZE + node)
        return sorted(out)

    def optical_partner(self, group: int, local: int) -> tuple[int, int] | None:
        """OTIS rule: node x of group y ↔ node y of group x.

        No link when ``local ≥ G`` (the half variant's upper nodes have no
        transpose image) or at the self-transpose hole ``local == group``,
        where the rule maps (g, g) to itself.
        """
        if local >= self.num_groups or local == group:
            return None
        return (local, group)

    def electrical_edges(self) -> Iterator[tuple[int, int]]:
        """All undirected electrical edges as (gid_a, gid_b), a < b."""
        p = self.procs_per_group
        for g in range(self.num_groups):
            for local in range(p):
                for nb in self.electrical_neighbors(local):
                    a, b = self.global_id(g, local), self.global_id(g, nb)
                    if a < b:
                        yield (a, b)

    def optical_edges(self) -> Iterator[tuple[int, int]]:
        """All undirected optical edges as (gid_a, gid_b), a < b."""
        for g in range(self.num_groups):
            for local in range(self.procs_per_group):
                partner = self.optical_partner(g, local)
                if partner is not None:
                    a = self.global_id(g, local)
                    b = self.global_id(*partner)
                    if a < b:
                        yield (a, b)

    # ---- diagnostics ---------------------------------------------------------
    def electrical_edge_count_closed_form(self) -> int:
        """Per group: 9 intra-cell edges per cell + 6·(d_h−1)/2 hypercube
        edges per cell = 3·cells·(d_h+2); times G groups."""
        return self.num_groups * 3 * self.num_hhc_cells * (self.d_h + 2)

    def optical_edge_count_closed_form(self) -> int:
        """One transpose link per unordered group pair: G·(G−1)/2 (the
        diagonal (g,g) and, for the half variant, locals ≥ G have none)."""
        g = self.num_groups
        return g * (g - 1) // 2

    @functools.cached_property
    def summary(self) -> dict:
        return {
            "d_h": self.d_h,
            "variant": self.variant,
            "groups": self.num_groups,
            "procs_per_group": self.procs_per_group,
            "total_procs": self.total_procs,
            "hhc_cells_per_group": self.num_hhc_cells,
            "electrical_edges": sum(1 for _ in self.electrical_edges()),
            "optical_edges": sum(1 for _ in self.optical_edges()),
        }


def table_1_1() -> dict[tuple[int, str], tuple[int, int]]:
    """Reproduce Table 1.1: (d_h, variant) → (#groups, #processors)."""
    out = {}
    for d_h in (1, 2, 3, 4):
        for variant in ("full", "half"):
            t = OHHCTopology(d_h, variant)
            out[(d_h, variant)] = (t.num_groups, t.total_procs)
    return out
