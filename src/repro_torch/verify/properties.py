"""Metamorphic properties and fault-scenario stress (DESIGN.md §7); the
port's copy of ``repro.verify.properties``, over ``repro_torch.net``.

Oracle-free checks that hold for *any* correct sort, so they catch bug
classes a single ``np.sort`` comparison can miss (e.g. an executor that
"fixes up" its output by re-sorting a corrupted buffer would still pass
the oracle — but not duplicate-mass preservation against the original
input it was handed):

* **ordering**      — output is non-decreasing;
* **permutation**   — output is a permutation of the input (multiset
  equality via value/count tables — also duplicate-mass preservation);
* **shuffle invariance** — sorting any permutation of the input yields the
  identical array;
* **idempotence**   — sorting the output changes nothing;
* **pairing**       — ``sort_pairs`` keeps every (key, value) pair intact:
  the value column is the permutation that sorts the key column.

Fault stress: the paper's gather must survive degraded networks.  We take
the *actual per-processor bucket loads of an engine run* (the plan's chunk
sizes), rebuild the accumulation schedule for each
:class:`repro_torch.net.faults.FaultScenario`, and replay it through the
event-driven simulator — asserting complete delivery, zero simulator-level
reroutes (the rebuilt schedule must be self-sufficient), and a makespan no
better than the healthy network's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import SortEngine
from repro_torch.core.engine import _host
from repro_torch.core.schedule import AccumulationSchedule
from repro_torch.core.topology import OHHCTopology


@dataclasses.dataclass(frozen=True)
class CheckResult:
    check: str
    subject: str
    status: str  # 'pass' | 'fail'
    detail: str = ""


def _multiset_equal(a: np.ndarray, b: np.ndarray) -> bool:
    va, ca = np.unique(a, return_counts=True)
    vb, cb = np.unique(b, return_counts=True)
    return va.shape == vb.shape and bool(np.all(va == vb) and np.all(ca == cb))


def metamorphic_checks(
    eng: SortEngine, x: np.ndarray, *, subject: str = "", seed: int = 0
) -> list[CheckResult]:
    """Run the full metamorphic battery on one input through ``eng``."""
    x = np.asarray(x).ravel()
    out = np.asarray(eng.sort(x))
    results = []

    def add(check: str, ok: bool, detail: str = ""):
        results.append(CheckResult(check, subject, "pass" if ok else "fail", detail))

    add("ordering", bool(np.all(out[:-1] <= out[1:])), "output not non-decreasing")
    add(
        "permutation",
        _multiset_equal(x, out),
        "output is not a permutation of the input (duplicate mass changed)",
    )
    rng = np.random.default_rng(seed)
    shuffled = x.copy()
    rng.shuffle(shuffled)
    add(
        "shuffle-invariance",
        bool(np.array_equal(np.asarray(eng.sort(shuffled)), out)),
        "sorting a shuffled copy produced a different array",
    )
    add(
        "idempotence",
        bool(np.array_equal(np.asarray(eng.sort(out)), out)),
        "sorting the sorted output changed it",
    )
    return results


def pairs_pairing_check(
    eng: SortEngine, keys: np.ndarray, vals: np.ndarray, *, subject: str = ""
) -> list[CheckResult]:
    """``sort_pairs`` contract: keys come back sorted and the value column
    is a permutation that reproduces exactly the input (key, value) pairs."""
    keys = np.asarray(keys).ravel()
    vals = np.asarray(vals).ravel()
    ks, vs = eng.sort_pairs(keys, vals)
    # the flat path returns tensors on the engine's device
    ks, vs = _host(ks), _host(vs)
    results = []

    def add(check: str, ok: bool, detail: str = ""):
        results.append(CheckResult(check, subject, "pass" if ok else "fail", detail))

    add("pairs-ordering", bool(np.all(ks[:-1] <= ks[1:])), "keys not sorted")
    got = sorted(zip(ks.tolist(), vs.tolist()))
    want = sorted(zip(keys.tolist(), vals.tolist()))
    add("pairs-pairing", got == want, "(key, value) pairs were not preserved")
    return results


def fault_replay(
    topo: OHHCTopology,
    chunk_sizes: Sequence[int],
    *,
    groups: "Sequence[int] | None" = None,
    itemsize: int = 4,
) -> list[CheckResult]:
    """Replay the gather under optical-link faults with the plan's loads.

    ``chunk_sizes`` is the per-processor bucket load of an engine run (the
    ``counts`` field of ``SortEngine.last_report``) — the dist plan's
    actual traffic, not a uniform idealisation.  For each faulted group the
    degraded schedule must deliver every element to the master with no
    simulator-level rerouting, and cannot beat the healthy makespan.
    """
    from repro_torch.net.faults import (
        FaultScenario,
        GatherImpossible,
        degraded_gather_rounds,
    )
    from repro_torch.net.links import LinkModel
    from repro_torch.net.sim import simulate_schedule

    sizes = list(int(c) for c in chunk_sizes)
    if len(sizes) != topo.total_procs:
        raise ValueError(
            f"chunk_sizes has {len(sizes)} entries for {topo.total_procs} procs"
        )
    total = sum(sizes)
    lm = LinkModel()
    healthy = simulate_schedule(
        AccumulationSchedule.build(topo), topo,
        link_model=lm, chunk_sizes=sizes, itemsize=itemsize,
    )
    results = [
        CheckResult(
            "fault-healthy-delivery",
            "healthy",
            "pass" if healthy.master_elems == total else "fail",
            f"master got {healthy.master_elems}/{total}",
        )
    ]
    if groups is None:
        groups = (1, topo.num_groups - 1) if topo.num_groups > 2 else (1,)
    for g in groups:
        scenario = FaultScenario.optical_link_down(g)
        subject = scenario.name
        try:
            rounds = degraded_gather_rounds(topo, scenario)
            res = simulate_schedule(
                rounds, topo,
                link_model=lm, router=scenario.router(topo),
                chunk_sizes=sizes, itemsize=itemsize,
            )
        except GatherImpossible as e:
            results.append(CheckResult("fault-delivery", subject, "fail", str(e)))
            continue
        ok = res.master_elems == total
        results.append(
            CheckResult(
                "fault-delivery", subject, "pass" if ok else "fail",
                f"master got {res.master_elems}/{total}",
            )
        )
        results.append(
            CheckResult(
                "fault-no-sim-reroute", subject,
                "pass" if res.rerouted_messages == 0 else "fail",
                f"{res.rerouted_messages} sends still needed simulator reroutes",
            )
        )
        results.append(
            CheckResult(
                "fault-makespan-sane", subject,
                "pass" if res.total_time_s >= healthy.total_time_s - 1e-12 else "fail",
                f"degraded {res.total_time_s:.3e}s < healthy {healthy.total_time_s:.3e}s",
            )
        )
    return results


def fault_replay_for_engine_run(
    eng: SortEngine, x: np.ndarray, **kw
) -> list[CheckResult]:
    """Sort ``x``, then replay faults with that run's measured bucket loads."""
    eng.sort(x)
    report = eng.last_report or {}
    counts = report.get("counts")
    if counts is None:
        raise ValueError("engine report carries no per-bucket counts for this path")
    return fault_replay(eng.topo, np.asarray(counts), itemsize=x.dtype.itemsize, **kw)
