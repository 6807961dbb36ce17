"""Paper-grid scenario axes and pruning rules (DESIGN.md §7); the port's
copy of ``repro.verify.grid``, with the same axes, scenario ids and group ids.

One :class:`Scenario` is one cell of the paper's experiment grid, extended
along every axis the repo actually implements:

* ``dtype``   — the paper's "different integer array types"
  (int8/int16/int32/int64/uint32) plus float32;
* ``dist``    — the paper's §5 input classes (``ALL_DISTRIBUTIONS``:
  random/sorted/reversed/local + the beyond-paper duplicate-heavy class);
* ``n``       — size buckets chosen to hit distinct pow2 jit shape buckets
  (including a non-power-of-two and a sub-``P`` size);
* ``d_h``/``variant`` — OHHC dimension and group variant (Table 1.1);
* ``path``/``method`` — the execution path (``sim``/``host``/``dist``) and
  its splitter method.

Invalid combinations are *pruned, not skipped silently*:
:func:`prune_reason` returns a human-readable reason string, and the CLI
report carries every pruned cell so the grid's coverage is auditable.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Sequence

import numpy as np

from repro_torch.data import ALL_DISTRIBUTIONS

# The paper's "different integer array types", plus float32 (§2's TPU-native
# key type).  uint64/float64 are excluded: without jax x64 they have no
# exact jit path at all, and the host path already covers 64-bit via int64.
DTYPES = ("int8", "int16", "int32", "int64", "uint32", "float32")

# Distinct pow2 shape buckets: 64 (sub-P for d_h≥2 — more buckets than
# elements), 257 (odd, pads to 512), 1024 (exact pow2), 3072 (pads to 4096).
SIZE_BUCKETS = (64, 257, 1024, 3072)

DIMS = (1, 2, 3)

PATHS = ("sim", "host", "dist")
SIM_METHODS = ("paper", "sampled")
HOST_METHODS = ("paper", "sampled")
DIST_METHODS = ("paper", "sample", "hier", "valiant")


def methods_for(path: str) -> tuple[str, ...]:
    return {"sim": SIM_METHODS, "host": HOST_METHODS, "dist": DIST_METHODS}[path]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One executable cell of the conformance grid."""

    path: str
    method: str
    dtype: str
    dist: str
    n: int
    d_h: int
    variant: str = "full"
    seed: int = 7

    @property
    def scenario_id(self) -> str:
        """Stable key used by baselines; every axis value is spelled out."""
        var = "" if self.variant == "full" else f"-{self.variant}"
        return (
            f"{self.path}/{self.method}/{self.dtype}/{self.dist}"
            f"/n{self.n}/d{self.d_h}{var}"
        )

    @property
    def group_id(self) -> str:
        """Input-identity key: scenarios sharing it sort the *same array*
        and must agree output-for-output (the differential cross-check)."""
        var = "" if self.variant == "full" else f"-{self.variant}"
        return f"{self.dtype}/{self.dist}/n{self.n}/d{self.d_h}{var}/s{self.seed}"

    def make_input(self) -> np.ndarray:
        from repro_torch.data import make_array

        return make_array(self.dist, self.n, seed=self.seed, dtype=np.dtype(self.dtype))


def prune_reason(
    sc: Scenario, *, devices: int = 1, mesh_axes: int = 1, x64: "bool | None" = None
) -> str | None:
    """Why ``sc`` cannot run in this environment (None = runnable).

    ``devices``/``mesh_axes`` describe the available mesh; pruning is a
    property of (scenario, environment), never silent.  ``x64`` pins the
    64-bit-key rule: ``None`` means ``True`` here, since torch keeps 64-bit
    keys exact and the port's planner keeps them on the device; the
    baseline-facing grids pass ``False`` so the smoke baseline holds the
    reference's cell set exactly (the reference, without jax x64, sends
    64-bit keys to the host).
    """
    if x64 is None:
        x64 = True
    if sc.path not in PATHS:
        return f"unknown path {sc.path!r}"
    if sc.method not in methods_for(sc.path):
        return f"method {sc.method!r} invalid for path {sc.path!r}"
    if np.dtype(sc.dtype).itemsize == 8 and sc.path != "host" and not x64:
        return "64-bit keys downcast on jit paths without jax x64; host covers this cell"
    if sc.path == "dist":
        if devices < 2:
            return "dist path needs a >1-device mesh"
        if sc.method == "hier" and mesh_axes < 2:
            return "hier method needs a 2-axis (pod, data) mesh"
        if sc.n < devices:
            return "dist path needs at least one element per shard"
    return None


def _grid(
    paths: Sequence[str],
    dtypes: Sequence[str],
    dists: Sequence[str],
    sizes: Sequence[int],
    dims: Sequence[int],
    variants: Sequence[str] = ("full",),
) -> Iterator[Scenario]:
    for path, d_h, variant, dtype, dist, n in itertools.product(
        paths, dims, variants, dtypes, dists, sizes
    ):
        for method in methods_for(path):
            yield Scenario(path, method, dtype, dist, n, d_h, variant)


def full_grid(*, devices: int = 1, mesh_axes: int = 1) -> list[Scenario]:
    """Every runnable scenario of the full paper grid (pruned cells removed;
    use :func:`pruned_cells` for the audit list)."""
    scenarios = list(
        _grid(PATHS, DTYPES, ALL_DISTRIBUTIONS, SIZE_BUCKETS, DIMS)
    )
    # The half-group variant (Table 1.1's G = P/2 column) at d_h=1: the
    # other topology family, exercised on the single-box paths.
    scenarios += list(
        _grid(("sim", "host"), DTYPES, ALL_DISTRIBUTIONS, (1024,), (1,), ("half",))
    )
    return [
        sc
        for sc in scenarios
        if prune_reason(sc, devices=devices, mesh_axes=mesh_axes) is None
    ]


def smoke_grid(*, devices: int = 1, mesh_axes: int = 1) -> list[Scenario]:
    """The pruned CI grid: every axis value covered, ≥100 scenarios, small
    sizes only so the whole sweep stays in CI's fast lane.

    Structure: the complete dtype × dist × method plane for sim+host at
    d_h=1 over two sizes, plus dimension rows (d_h ∈ {2,3}), a half-variant
    row, and — when a mesh exists — a dist row per method.
    """
    scenarios: list[Scenario] = []
    # The dense plane: both single-box paths, all dtypes, all input classes.
    scenarios += _grid(("sim", "host"), DTYPES, ALL_DISTRIBUTIONS, (257, 1024), (1,))
    # Dimension axis: higher d_h on the jit path (P = 144 / 576), including
    # the n < P cell where most buckets stay empty.
    scenarios += _grid(("sim",), ("int32",), ("random", "dupes"), (64, 1024), (2, 3))
    # Variant axis: the half-group topology.
    scenarios += _grid(
        ("sim", "host"), ("int32", "uint32"), ("random", "local"), (1024,), (1,), ("half",)
    )
    # Mesh axis (only when the environment has one; the port has no dist
    # path yet, so these cells are always pruned): every dist method on the
    # main dtypes.
    scenarios += _grid(
        ("dist",), ("int32", "uint32", "float32"), ("random", "dupes", "sorted"),
        (1024, 3072), (1,),
    )
    # x64=False pins the cell set to the reference's: the smoke baseline
    # holds no int64 sim cells, which the port runs on its kernels only in
    # the full grid.
    return [
        sc
        for sc in scenarios
        if prune_reason(sc, devices=devices, mesh_axes=mesh_axes, x64=False) is None
    ]


def tier1_grid() -> list[Scenario]:
    """The fast pytest subset — a strict subset of :func:`smoke_grid` (so
    the committed smoke baseline covers it) touching every dtype, every
    distribution, both single-box paths, and one higher-dimension cell."""
    smoke = {sc.scenario_id: sc for sc in smoke_grid(devices=1)}
    picked: list[Scenario] = []
    for dtype, dist in zip(
        ("int8", "int16", "int32", "int64", "uint32", "float32", "int32", "int32"),
        ("random", "dupes", "local", "sorted", "reversed", "random", "dupes", "sorted"),
    ):
        for path in ("sim", "host"):
            sc = Scenario(path, "paper", dtype, dist, 257, 1)
            if sc.scenario_id in smoke:
                picked.append(smoke[sc.scenario_id])
    # sampled-method and dimension coverage
    for sc in (
        Scenario("sim", "sampled", "uint32", "local", 257, 1),
        Scenario("sim", "sampled", "int8", "random", 257, 1),
        Scenario("host", "sampled", "int64", "random", 257, 1),
        Scenario("sim", "paper", "int32", "random", 64, 2),
    ):
        if sc.scenario_id in smoke:
            picked.append(smoke[sc.scenario_id])
    # dedupe, preserve order
    seen: set[str] = set()
    out = []
    for sc in picked:
        if sc.scenario_id not in seen:
            seen.add(sc.scenario_id)
            out.append(sc)
    return out


# ---------------------------------------------------------------- segments
# The segmented-batch twin of the grid above: one SegmentScenario is one
# forced (row-sort method × dtype × row class × length mix) cell of the
# ``sort_segments`` hot path, covering every row backend the engine's
# autotune can pick (vmapped XLA and both fused Pallas variants) so the
# drift baseline owns the batched kernel too (DESIGN.md §7, §8).

SEGMENT_METHODS = ("bitonic", "bitonic_pallas", "bitonic2op")

# Row classes: uniform keys, dtype-max sentinel-tie mixes (the pad-collision
# class the tagged kernels exist for), all-equal rows, reversed ramps.
SEGMENT_ROW_CLASSES = ("random", "ties", "equal", "ramp")

# Longest-row values straddling pow2 shape buckets (128 and 1024).
SEGMENT_MAX_LENS = (100, 1000)

SEGMENT_DTYPES = ("int32", "uint32", "float32")


@dataclasses.dataclass(frozen=True)
class SegmentScenario:
    """One executable cell of the segmented-batch conformance grid."""

    method: str  # forced row-sort method (SEGMENT_METHODS)
    dtype: str
    rows: str  # row class (SEGMENT_ROW_CLASSES)
    max_len: int  # longest row; the pow2 bucket comes from bucketed_length
    seed: int = 7

    # the single-array grid's duck-typed surface (baseline + cross-check)
    path = "sim"

    @property
    def scenario_id(self) -> str:
        return f"seg/{self.method}/{self.dtype}/{self.rows}/L{self.max_len}"

    @property
    def group_id(self) -> str:
        """Cells sharing it sort the same batch: every method must agree."""
        return f"seg/{self.dtype}/{self.rows}/L{self.max_len}/s{self.seed}"

    def make_batch(self) -> "tuple[np.ndarray, list[int]]":
        """The flat keys + segment lengths for this cell (deterministic).

        Lengths include the degenerate rows (0, 1) plus draws up to
        ``max_len`` so the batch straddles intra-bucket variation.
        """
        rng = np.random.default_rng(self.seed + self.max_len)
        lens = [0, 1, self.max_len] + [
            int(v) for v in rng.integers(2, self.max_len + 1, 4)
        ]
        dt = np.dtype(self.dtype)
        segs = []
        for n in lens:
            if self.rows == "random":
                if np.issubdtype(dt, np.integer):
                    info = np.iinfo(dt)
                    segs.append(rng.integers(info.min, info.max, n, dtype=dt))
                else:
                    segs.append(rng.normal(size=n).astype(dt))
            elif self.rows == "ties":
                hi = np.iinfo(dt).max
                segs.append(np.where(rng.random(n) < 0.5, hi, hi - 1).astype(dt))
            elif self.rows == "equal":
                segs.append(np.full(n, 42, dt))
            elif self.rows == "ramp":
                segs.append(np.arange(n, 0, -1).astype(dt))
            else:
                raise ValueError(f"unknown row class {self.rows!r}")
        flat = np.concatenate(segs) if segs else np.zeros(0, dt)
        return flat, lens


def segment_prune_reason(sc: SegmentScenario) -> "str | None":
    if sc.method not in SEGMENT_METHODS:
        return f"unknown segment method {sc.method!r}"
    if sc.rows not in SEGMENT_ROW_CLASSES:
        return f"unknown row class {sc.rows!r}"
    if sc.rows == "ties" and not np.issubdtype(np.dtype(sc.dtype), np.integer):
        return "sentinel-tie rows are an integer-key class (float pad is +inf)"
    return None


def segment_smoke_grid() -> "list[SegmentScenario]":
    """Every runnable segment cell: method × dtype × row class × length."""
    out = []
    for method, dtype, rows, max_len in itertools.product(
        SEGMENT_METHODS, SEGMENT_DTYPES, SEGMENT_ROW_CLASSES, SEGMENT_MAX_LENS
    ):
        sc = SegmentScenario(method, dtype, rows, max_len)
        if segment_prune_reason(sc) is None:
            out.append(sc)
    return out


def segment_tier1_grid() -> "list[SegmentScenario]":
    """Fast pytest subset: every method and row class at one size each."""
    picked = [
        SegmentScenario("bitonic", "int32", "random", 100),
        SegmentScenario("bitonic_pallas", "int32", "ties", 100),
        SegmentScenario("bitonic_pallas", "uint32", "random", 1000),
        SegmentScenario("bitonic2op", "int32", "equal", 1000),
        SegmentScenario("bitonic2op", "uint32", "ties", 100),
        SegmentScenario("bitonic_pallas", "float32", "ramp", 1000),
    ]
    smoke_ids = {sc.scenario_id for sc in segment_smoke_grid()}
    return [sc for sc in picked if sc.scenario_id in smoke_ids]


# ------------------------------------------------------------------ faults
# The degraded-topology slice of the grid (DESIGN.md §11): one FaultCell is
# one (fault class × topology × path) cell run with the engine's
# ``fault_scenario`` set.  Cells sharing a topology sort the *same* input,
# so the cross-check asserts the degraded runs (and the typed host
# fallbacks of impossible scenarios) stay byte-identical to the healthy
# run — the "zero wrong answers under faults" pin.

# healthy  — scenario None, the byte-reference the others must match;
# optical  — group 1's OTIS uplink dead (reroutable: relay chains);
# klinks2  — 2 seeded-random dead links (reroutable on every grid topo);
# uplinks  — every OTIS uplink of group 1 dead (GatherImpossible: the
#            group is optically islanded → typed host fallback);
# worker   — group 1's hub node dead (GatherImpossible: internal
#            destination → typed host fallback; the fleet's kill twin).
FAULT_CLASSES = ("healthy", "optical", "klinks2", "uplinks", "worker")

# Fault classes whose gather is impossible: forced sim plans must come back
# rewritten to the host path (the fallback ladder's bottom rung).
FAULT_IMPOSSIBLE = ("uplinks", "worker")

FAULT_TOPOLOGIES = ((1, "full"), (2, "full"), (1, "half"))

FAULT_PATHS = ("sim", "host")


@dataclasses.dataclass(frozen=True)
class FaultCell:
    """One executable cell of the degraded-topology conformance grid."""

    fault: str  # FAULT_CLASSES
    d_h: int
    variant: str
    path: str  # requested path; the *executed* path lands in the baseline
    n: int = 2048
    seed: int = 11

    # the single-array grid's duck-typed surface (forced_plan + baselines)
    method = "paper"

    @property
    def scenario_id(self) -> str:
        var = "" if self.variant == "full" else f"-{self.variant}"
        return f"fault/{self.fault}/d{self.d_h}{var}/{self.path}"

    @property
    def group_id(self) -> str:
        """Same topology ⇒ same input: every fault class and path in the
        group must agree byte-for-byte with the healthy cell."""
        var = "" if self.variant == "full" else f"-{self.variant}"
        return f"fault/d{self.d_h}{var}/n{self.n}/s{self.seed}"

    def make_input(self) -> np.ndarray:
        from repro_torch.data import make_array

        return make_array("random", self.n, seed=self.seed, dtype=np.dtype("int32"))

    def scenario(self, topo):
        """The cell's FaultScenario on ``topo`` (None for the healthy ref)."""
        from repro_torch.net.faults import FaultScenario

        if self.fault == "healthy":
            return None
        if self.fault == "optical":
            return FaultScenario.optical_link_down(1)
        if self.fault == "klinks2":
            return FaultScenario.random_links(topo, 2, seed=3)
        if self.fault == "uplinks":
            return FaultScenario.group_uplinks_down(topo, 1)
        if self.fault == "worker":
            return FaultScenario.worker_down(1)
        raise ValueError(f"unknown fault class {self.fault!r}")


def fault_grid() -> "list[FaultCell]":
    """Every degraded-grid cell: fault class × topology × path (no pruning
    — every class is constructible on every grid topology, and impossible
    scenarios are *cells that must fall back*, not cells to skip)."""
    return [
        FaultCell(fault, d_h, variant, path)
        for fault in FAULT_CLASSES
        for d_h, variant in FAULT_TOPOLOGIES
        for path in FAULT_PATHS
    ]


# --------------------------------------------------------------- workloads
# The operation axis of the grid (DESIGN.md §12): the paper varies
# dimension/dtype/distribution/size for ONE op (full sort); these cells
# vary the op itself.  Each op has its own oracle (run_op_scenario), and
# ops producing the full sorted array share a byte-compare group with the
# plain sort cell of the same input.

WORKLOAD_OPS = ("sort", "top_k", "pairs_pytree", "merge")

OP_DTYPES = ("int32", "uint32", "float32")
OP_DISTS = ("random", "dupes", "local")
OP_SIZES = (257, 2048)
# top_k runs at two head fractions: k = n//8 lands in the host skip regime
# (most buckets past the cut), k = n//2 keeps the sim partial-sort path
# live — both dispatch arms stay pinned.
OP_K_DIVS = (8, 2)


@dataclasses.dataclass(frozen=True)
class OpScenario:
    """One executable cell of the workload conformance grid."""

    op: str  # WORKLOAD_OPS
    dtype: str
    dist: str
    n: int
    k_div: int = 0  # top_k only: k = max(1, n // k_div)
    seed: int = 7

    # the single-array grid's duck-typed surface; the *executed* path and
    # method land in the baseline from the engine report
    path = "sim"
    method = "op"

    @property
    def k(self) -> int:
        return max(1, self.n // self.k_div) if self.k_div else 0

    @property
    def scenario_id(self) -> str:
        kk = f"/k{self.k}" if self.op == "top_k" else ""
        return f"op/{self.op}/{self.dtype}/{self.dist}/n{self.n}{kk}"

    @property
    def group_id(self) -> str:
        """sort, pairs_pytree, and merge all produce the full sorted array
        of the same input → one byte-compare group; top_k heads group per
        ``k`` (every op computing the same head must agree)."""
        head = f"head{self.k}" if self.op == "top_k" else "full"
        return f"op/{head}/{self.dtype}/{self.dist}/n{self.n}/s{self.seed}"

    def make_input(self) -> np.ndarray:
        from repro_torch.data import make_array

        return make_array(
            self.dist, self.n, seed=self.seed, dtype=np.dtype(self.dtype)
        )


def op_prune_reason(sc: OpScenario) -> "str | None":
    if sc.op not in WORKLOAD_OPS:
        return f"unknown op {sc.op!r}"
    if sc.op == "top_k" and sc.k_div == 0:
        return "top_k cells need a k divisor"
    if sc.op != "top_k" and sc.k_div != 0:
        return f"{sc.op} cells take no k divisor"
    if np.dtype(sc.dtype).itemsize == 8:
        return "64-bit keys ride the single-array grid's host rows"
    return None


def op_smoke_grid() -> "list[OpScenario]":
    """Every runnable op cell: op × dtype × distribution × size (+ k)."""
    out = []
    for dtype, dist, n in itertools.product(OP_DTYPES, OP_DISTS, OP_SIZES):
        for op in WORKLOAD_OPS:
            if op == "top_k":
                out.extend(
                    OpScenario(op, dtype, dist, n, k_div) for k_div in OP_K_DIVS
                )
            else:
                out.append(OpScenario(op, dtype, dist, n))
    return [sc for sc in out if op_prune_reason(sc) is None]


def op_tier1_grid() -> "list[OpScenario]":
    """Fast pytest subset: every op, both top_k regimes, mixed dtypes."""
    picked = [
        OpScenario("sort", "int32", "random", 257),
        OpScenario("top_k", "int32", "random", 257, 8),
        OpScenario("top_k", "int32", "dupes", 2048, 2),
        OpScenario("top_k", "uint32", "local", 2048, 8),
        OpScenario("pairs_pytree", "int32", "random", 257),
        OpScenario("pairs_pytree", "float32", "dupes", 2048),
        OpScenario("merge", "int32", "random", 2048),
        OpScenario("merge", "uint32", "dupes", 257),
    ]
    smoke_ids = {sc.scenario_id for sc in op_smoke_grid()}
    return [sc for sc in picked if sc.scenario_id in smoke_ids]


def pruned_cells(
    scenarios: "Sequence[Scenario] | None" = None,
    *,
    devices: int = 1,
    mesh_axes: int = 1,
) -> list[tuple[Scenario, str]]:
    """The audit list: every (scenario, reason) the environment prunes."""
    if scenarios is None:
        scenarios = list(_grid(PATHS, DTYPES, ALL_DISTRIBUTIONS, SIZE_BUCKETS, DIMS))
    out = []
    for sc in scenarios:
        reason = prune_reason(sc, devices=devices, mesh_axes=mesh_axes)
        if reason is not None:
            out.append((sc, reason))
    return out
