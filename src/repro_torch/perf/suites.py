"""The gated perf scenarios, one registry per bench suite (DESIGN.md §9).

The port's copy of ``repro.perf.suites``: the same suites, case ids,
workloads, tolerance bands, seeds and smoke flags, each setup driving the
port's entry point on ``device`` (the card by default; ``"cpu"`` runs the
kernels' plain versions).  Each case is pinned to a small, deterministic
slice sized for a gate: the point is a *stable judged number per case*.
Every case builds its inputs, builds its kernels (nvcc at a kernel's
first launch) and makes one untimed call inside ``setup``, so the timed
call measures steady-state work only, and every RNG draw is seeded.

Three ids name a JAX mechanism in the reference and are renamed here;
``REFERENCE_KEY`` maps each to the reference's id:

* ``jnp_sort/*`` → ``torch_sort/*``: the library baseline the hand kernels
  race, a ``torch.sort`` call by design;
* ``bitonic_interpret/4096`` → ``bitonic/4096``: ``ops.local_sort``, the
  tile sort K2 on the card;
* ``rowsort_vmap`` → ``rowsort_torch`` (``torch.sort(dim=-1)``), and
  ``rowsort_pallas`` / ``rowsort_pallas2op`` → ``rowsort_cuda`` /
  ``rowsort_cuda2op`` (the row sort K4, ``batched.batched_row_sort``).

Work models (``Workload``) are honest lower bounds — inputs read once,
outputs written once, ``n·log2(n)`` comparison "flops" for a sort — so
``pct_of_roofline`` is comparable across cases and the normalized ratio is
portable across devices (see ``repro_torch.perf.normalize``).  The netsim
suite has no bytes-moved model (its cost is simulator events), so it opts
out and is judged on raw seconds, machine-local by declaration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.perf.normalize import Workload
from repro_torch.perf.schema import PerfCase

SUITE_NAMES = (
    "engine", "sortd", "kernels", "netsim", "verify", "fleet", "faults",
    "workloads",
)

# The port's case id → the reference's, where an id names a JAX mechanism.
REFERENCE_KEY = {
    "kernels/torch_sort/65536": "kernels/jnp_sort/65536",
    "kernels/torch_sort/262144": "kernels/jnp_sort/262144",
    "kernels/bitonic/4096": "kernels/bitonic_interpret/4096",
    "kernels/rowsort_torch/B64xL1024": "kernels/rowsort_vmap/B64xL1024",
    "kernels/rowsort_cuda/B64xL1024": "kernels/rowsort_pallas/B64xL1024",
    "kernels/rowsort_cuda2op/B64xL1024": "kernels/rowsort_pallas2op/B64xL1024",
}


def _sort_workload(n: int, itemsize: int) -> Workload:
    return Workload(
        bytes_moved=2.0 * n * itemsize,
        flops=float(n) * math.log2(max(n, 2)),
    )


def _warm(fn):
    """One untimed call (kernel builds, executor caches), then ``fn``."""
    fn()
    return fn


# --- engine ---------------------------------------------------------------


def _engine_setup(dist: str, n: int, dtype: str, device):
    def setup():
        from repro_torch.core import SortEngine
        from repro_torch.data.distributions import make_array

        eng = SortEngine(device=device)
        x = make_array(dist, n, seed=n, dtype=np.dtype(dtype))
        return _warm(lambda: eng.sort(x))

    return setup


def engine_cases(*, smoke: bool = True, device="cuda") -> "list[PerfCase]":
    cells = [("random", 65536, "int32", True), ("dupes", 65536, "int32", True)]
    if not smoke:
        cells += [
            ("random", 262144, "int32", False),
            ("local", 65536, "int32", False),
            ("random", 65536, "uint32", False),
        ]
    return [
        PerfCase(
            suite="engine",
            key=f"sort/{dist}/{n}/{dtype}",
            setup=_engine_setup(dist, n, dtype, device),
            workload=_sort_workload(n, np.dtype(dtype).itemsize),
            smoke=in_smoke,
        )
        for dist, n, dtype, in_smoke in cells
    ]


# --- sortd ----------------------------------------------------------------


def _segments_setup(batch: int, lo: int, hi: int, dtype: str, device):
    def setup():
        from repro_torch.core import SortEngine

        eng = SortEngine(device=device)
        rng = np.random.default_rng(7)
        lens = rng.integers(lo, hi, batch)
        arrs = [rng.integers(0, 1 << 30, n).astype(dtype) for n in lens]
        flat = np.concatenate(arrs)
        seg_lens = [int(a.size) for a in arrs]
        return _warm(lambda: eng.sort_segments(flat, seg_lens))

    return setup


def sortd_cases(*, smoke: bool = True, device="cuda") -> "list[PerfCase]":
    cells = [(64, True)]
    if not smoke:
        cells += [(256, False)]
    out = []
    for batch, in_smoke in cells:
        # mean segment length (lo+hi)/2 sizes the work model; the draw is
        # seeded, so the realized total is fixed per case anyway.
        lo, hi = 256, 2048
        total = batch * (lo + hi) // 2
        out.append(PerfCase(
            suite="sortd",
            key=f"sort_segments/B{batch}/int32",
            setup=_segments_setup(batch, lo, hi, "int32", device),
            workload=_sort_workload(total, 4),
            smoke=in_smoke,
        ))
    return out


# --- kernels --------------------------------------------------------------


def _torch_sort_setup(n: int, device):
    def setup():
        from repro_torch.data.distributions import make_array

        x = torch.from_numpy(make_array("random", n, seed=n)).to(device)
        return _warm(lambda: torch.sort(x).values)

    return setup


def _local_sort_setup(n: int, device):
    def setup():
        from repro_torch.data.distributions import make_array
        from repro_torch.kernels import ops

        x = torch.from_numpy(make_array("random", n, seed=n)).to(device)
        return _warm(lambda: ops.local_sort(x))

    return setup


def _rowsort_setup(backend: str, B: int, L: int, device):
    """One segment-path row backend on a fixed full-range int32 batch:
    ``torch`` is the library's row sort, the cuda backends call the row
    sort K4 (``repro_torch.kernels.batched``) directly — the candidates
    the engine's ``choose_row_backend`` autotune races."""

    def setup():
        from repro_torch.kernels import batched

        rng = np.random.default_rng(L)
        info = np.iinfo(np.int32)
        x = torch.from_numpy(rng.integers(info.min, info.max, (B, L), dtype=np.int32)).to(device)
        if backend == "torch":
            return _warm(lambda: torch.sort(x, dim=-1).values)
        lens = torch.full((B,), L, dtype=torch.int32, device=device)
        method = {"cuda": "bitonic", "cuda2op": "bitonic2op"}[backend]
        return _warm(lambda: batched.batched_row_sort(x, lens, method=method))

    return setup


def kernels_cases(*, smoke: bool = True, device="cuda") -> "list[PerfCase]":
    # The reference gave the row backends and its interpreted tile sort the
    # wide netsim-style band; the port keeps every band.
    wide = {"lower": 0.70, "upper": 1.50}
    cases = [
        PerfCase(
            suite="kernels",
            key="torch_sort/65536",
            setup=_torch_sort_setup(65536, device),
            workload=_sort_workload(65536, 4),
        ),
        PerfCase(
            suite="kernels",
            key="bitonic/4096",
            setup=_local_sort_setup(4096, device),
            workload=_sort_workload(4096, 4),
            **wide,
        ),
        # The row-backend A/B the engine's autotune stands on, persisted as
        # paired baseline rows: the committed raw_s ratio documents which
        # backend wins the B64xL1024 serving bucket on this device, and
        # the gate re-judges each side on every run.
        PerfCase(
            suite="kernels",
            key="rowsort_torch/B64xL1024",
            setup=_rowsort_setup("torch", 64, 1024, device),
            workload=_sort_workload(64 * 1024, 4),
            **wide,
        ),
        PerfCase(
            suite="kernels",
            key="rowsort_cuda/B64xL1024",
            setup=_rowsort_setup("cuda", 64, 1024, device),
            workload=_sort_workload(64 * 1024, 4),
            **wide,
        ),
    ]
    if not smoke:
        cases += [
            PerfCase(
                suite="kernels",
                key="torch_sort/262144",
                setup=_torch_sort_setup(262144, device),
                workload=_sort_workload(262144, 4),
                smoke=False,
            ),
            PerfCase(
                suite="kernels",
                key="rowsort_cuda2op/B64xL1024",
                setup=_rowsort_setup("cuda2op", 64, 1024, device),
                workload=_sort_workload(64 * 1024, 4),
                smoke=False,
                **wide,
            ),
        ]
    return cases


# --- netsim ---------------------------------------------------------------


def _netsim_setup(dims: tuple, chunk_elems: int):
    def setup():
        from repro_torch.net.report import netsim_report

        return _warm(lambda: netsim_report(dims=dims, chunk_elems=chunk_elems))

    return setup


def netsim_cases(*, smoke: bool = True, device="cuda") -> "list[PerfCase]":
    # The simulator runs on the host whatever the device.
    cells = [((1,), 256, True)]
    if not smoke:
        cells += [((1, 2), 1024, False)]
    return [
        PerfCase(
            suite="netsim",
            key=f"report/d{'-'.join(map(str, dims))}/chunk{chunk}",
            setup=_netsim_setup(dims, chunk),
            workload=None,  # event-loop cost; raw-seconds fallback
            # Raw seconds on a pure-python event loop swing ~2x run to
            # run (GC, allocator state); the band is wide by declaration.
            lower=0.70,
            upper=1.50,
            smoke=in_smoke,
        )
        for dims, chunk, in_smoke in cells
    ]


# --- fleet ----------------------------------------------------------------


def _fleet_loop_setup(workers: "int | None", n_req: int, clients: int, device):
    """Closed-loop drive of a persistent warm service; ``workers=None``
    means the single-Sortd baseline (shipped default config).  The timed
    callable carries the service's ``close``: the runner stops its
    threads once the case is measured."""

    def setup():
        from repro_torch.core import SortEngine
        from repro_torch.serve.fleet import FleetConfig, SortdFleet
        from repro_torch.serve.fleet.loadgen import drive_closed_loop, request_mix
        from repro_torch.serve.sortd import Sortd, SortdConfig

        reqs = request_mix(n_req, seed=11)
        if workers is None:
            svc = Sortd(SortEngine(device=device), SortdConfig(max_queue=4096))
        else:
            # Lax heartbeat: the workers' cold first flushes (kernel
            # builds, row-backend probes) contend and can each stall >1s;
            # the case measures the steady-state loop, not failover, so a
            # cold pause must not get a worker declared dead mid-warmup.
            svc = SortdFleet(
                FleetConfig(workers=workers, heartbeat_timeout_s=10.0),
                engine_factory=lambda wid: SortEngine(device=device),
            )
        # warm every bucket's executable on every worker; the service stays
        # live across the timed repeats
        drive_closed_loop(svc.submit, request_mix(60, seed=3), clients=clients)

        def run():
            return drive_closed_loop(svc.submit, reqs, clients=clients)

        run.close = svc.close
        return run

    return setup


def fleet_cases(*, smoke: bool = True, device="cuda") -> "list[PerfCase]":
    # Paired cases on the SAME mix/clients: the baseline file's raw_s
    # ratio (single / w4) documents the fleet's scaling at c=2, and the
    # gate re-judges each side on every run.  Timing is cross-thread
    # scheduling, not device work — no honest bytes/flops model — so the
    # cases opt out of normalization and carry the wide netsim-style band.
    n_req, clients = (80, 2) if smoke else (240, 2)
    band = {"lower": 0.70, "upper": 1.50}
    return [
        PerfCase(
            suite="fleet",
            key=f"closed/single/c{clients}",
            setup=_fleet_loop_setup(None, n_req, clients, device),
            workload=None,
            **band,
        ),
        PerfCase(
            suite="fleet",
            key=f"closed/w4/c{clients}",
            setup=_fleet_loop_setup(4, n_req, clients, device),
            workload=None,
            **band,
        ),
    ]


# --- faults ---------------------------------------------------------------


def _fault_predict_setup(d_h: int, n: int):
    """The degraded-plan pricing machinery end to end: schedule rebuild
    under the faulted router + both simulator accountings (the work
    ``SortEngine._comm_price`` does once per (bucket, scenario)); host
    only."""

    def setup():
        from repro_torch.core.topology import OHHCTopology
        from repro_torch.net.faults import FaultScenario, predicted_slowdown

        topo = OHHCTopology(d_h, "full")
        sc = FaultScenario.optical_link_down(1)
        chunk = max(1, n // topo.total_procs)

        def run():
            predicted_slowdown(topo, sc, chunk_sizes=chunk, barrier=True)
            predicted_slowdown(topo, sc, chunk_sizes=chunk, barrier=False)

        return _warm(run)

    return setup


def _fault_sort_setup(n: int, dtype: str, device):
    """Steady-state degraded serving: a warm engine with an active fault
    scenario sorting on the re-priced sim path (plan + comm caches hot, so
    the timed call is the sort itself — the §11 contract that degraded
    mode costs planning once, not per request)."""

    def setup():
        from repro_torch.core import SortEngine
        from repro_torch.data.distributions import make_array
        from repro_torch.net.faults import FaultScenario

        eng = SortEngine(device=device)
        eng.set_fault_scenario(FaultScenario.optical_link_down(1))
        x = make_array("random", n, seed=n, dtype=np.dtype(dtype))
        return _warm(lambda: eng.sort(x))

    return setup


def faults_cases(*, smoke: bool = True, device="cuda") -> "list[PerfCase]":
    # Python event-loop + rebuild cost on one side, the sort on the other;
    # the pricing case is judged raw-seconds with the wide netsim-style
    # band, the sort case normalized like the engine suite.
    band = {"lower": 0.70, "upper": 1.50}
    cases = [
        PerfCase(
            suite="faults",
            key="predict/optical_g1/d1/n65536",
            setup=_fault_predict_setup(1, 65536),
            workload=None,
            **band,
        ),
        PerfCase(
            suite="faults",
            key="sort/degraded/optical_g1/random/65536/int32",
            setup=_fault_sort_setup(65536, "int32", device),
            workload=_sort_workload(65536, 4),
        ),
    ]
    return cases


# --- workloads ------------------------------------------------------------


def _topk_setup(n: int, k: int, device):
    def setup():
        from repro_torch.core import SortEngine
        from repro_torch.data.distributions import make_array

        eng = SortEngine(device=device)
        x = make_array("random", n, seed=n)
        return _warm(lambda: eng.top_k(x, k))

    return setup


def _fullsort_setup(n: int, device):
    """The full-sort half of the top-k pair — same seeded input, so the
    committed raw_s ratio IS the skip-rule margin the gate re-judges."""

    def setup():
        from repro_torch.core import SortEngine
        from repro_torch.data.distributions import make_array

        eng = SortEngine(device=device)
        x = make_array("random", n, seed=n)
        return _warm(lambda: eng.sort(x))

    return setup


def _merge_tick_setup(n_buf: int, n_new: int, device):
    def setup():
        from repro_torch.core import SortEngine
        from repro_torch.data.distributions import make_array

        eng = SortEngine(device=device)
        buf = np.sort(make_array("random", n_buf, seed=3))
        new = make_array("random", n_new, seed=4)
        return _warm(lambda: eng.merge_sorted(buf, new))

    return setup


def _pairs_pytree_setup(n: int, device):
    def setup():
        from repro_torch.core import SortEngine
        from repro_torch.data.distributions import make_array

        eng = SortEngine(device=device)
        keys = make_array("random", n, seed=5)
        idx = np.arange(n, dtype=np.int64)
        vals = {"idx": idx, "nested": (keys.astype(np.float64),)}
        return _warm(lambda: eng.sort_pairs(keys, vals))

    return setup


def _moe_dispatch_setup(dispatch: str, device):
    """One MoE layer's eager forward in bf16 (the reference times its
    ``jax.jit`` of the same layer); the weights and the input come from
    seeded generators on ``device``."""

    def setup():
        from repro_torch.configs.base import MoEConfig, ModelConfig
        from repro_torch.models import moe as MOE
        from repro_torch.models.common import NO_SHARD

        cfg = ModelConfig(
            family="moe", d_model=256, dtype=torch.bfloat16,
            moe=MoEConfig(
                num_experts=8, num_experts_per_tok=2, expert_d_ff=512,
                dispatch=dispatch, capacity_factor=1.25,
            ),
        )
        p = MOE.init_moe(torch.Generator(device).manual_seed(0), cfg)
        x = torch.randn((1, 512, 256), generator=torch.Generator(device).manual_seed(1), device=device,
                        dtype=torch.bfloat16)

        def run():
            with torch.no_grad():
                return MOE.apply_moe(p, x, cfg, NO_SHARD)[0]

        return _warm(run)

    return setup


def workloads_cases(*, smoke: bool = True, device="cuda") -> "list[PerfCase]":
    """The §12 workload layer, gated as paired rows.

    ``topk`` and ``fullsort`` share the same seeded input: the committed
    ``raw_s`` ratio between them is the skip-rule speedup (top-k must beat
    a full sort at n≥4096, k≤n/16); the gate re-judges each side against
    its own baseline every run.  Host-path ops (top-k's numpy head, the
    merge gather) are microsecond-scale python+numpy — raw-seconds with
    the wide band, no device work model.
    """
    band = {"lower": 0.70, "upper": 1.50}
    n = 65536
    cases = [
        PerfCase(
            suite="workloads",
            key=f"topk/random/{n}/k{n // 16}",
            setup=_topk_setup(n, n // 16, device),
            workload=None,
            **band,
        ),
        PerfCase(
            suite="workloads",
            key=f"fullsort/random/{n}",
            setup=_fullsort_setup(n, device),
            workload=_sort_workload(n, 4),
        ),
        PerfCase(
            suite="workloads",
            key="merge_tick/buf65536/new2048",
            setup=_merge_tick_setup(65536, 2048, device),
            workload=None,
            **band,
        ),
        PerfCase(
            suite="workloads",
            key="pairs_pytree/random/4096",
            setup=_pairs_pytree_setup(4096, device),
            workload=_sort_workload(4096, 4),
            **band,
        ),
    ]
    if not smoke:
        cases += [
            PerfCase(
                suite="workloads",
                key=f"moe_dispatch/{dispatch}/E8k2T512",
                setup=_moe_dispatch_setup(dispatch, device),
                workload=None,
                smoke=False,
                **band,
            )
            for dispatch in ("sorted", "argsort")
        ]
    return cases


# --- verify ---------------------------------------------------------------


def _verify_setup(dtype: str, device):
    def setup():
        from repro_torch.verify import differential, grid

        scenarios = [sc for sc in grid.tier1_grid() if sc.dtype == dtype]
        engines = differential.EngineCache(devices=1, device=device)
        # warm every (shape bucket, method) executable in the slice
        return _warm(lambda: differential.run_grid(scenarios, keep_outputs=False, engines=engines))

    return setup


def _verify_workload(dtype: str) -> Workload:
    from repro_torch.verify import grid

    total_bytes = 0.0
    total_flops = 0.0
    for sc in grid.tier1_grid():
        if sc.dtype != dtype:
            continue
        w = _sort_workload(sc.n, np.dtype(sc.dtype).itemsize)
        total_bytes += w.bytes_moved
        total_flops += w.flops
    return Workload(bytes_moved=total_bytes, flops=total_flops)


def verify_cases(*, smoke: bool = True, device="cuda") -> "list[PerfCase]":
    dtypes = ["int32"] if smoke else ["int32", "uint32"]
    return [
        PerfCase(
            suite="verify",
            key=f"tier1/{dtype}",
            setup=_verify_setup(dtype, device),
            workload=_verify_workload(dtype),
            smoke=dtype == "int32",
        )
        for dtype in dtypes
    ]


SUITES = {
    "engine": engine_cases,
    "sortd": sortd_cases,
    "kernels": kernels_cases,
    "netsim": netsim_cases,
    "verify": verify_cases,
    "fleet": fleet_cases,
    "faults": faults_cases,
    "workloads": workloads_cases,
}


def cases_for(suite: str, *, smoke: bool = True, device="cuda") -> "list[PerfCase]":
    if suite not in SUITES:
        raise KeyError(f"unknown perf suite {suite!r}; choose from {SUITE_NAMES}")
    return SUITES[suite](smoke=smoke, device=device)
