"""The sort service: one client calling ``SortEngine.sort`` in a closed loop.

The engine is built from the configuration (``OHHCTopology(d_h, variant)``
and its ``host_threshold``); the requests cycle a pool of arrays that the
generator makes from the seed.  A traced call runs the same work split at
the planner's boundary: ``stats`` and ``plan`` under the span ``plan``,
then ``sort(x, plan=plan)`` under ``sort_call``.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from cardbench import generate


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, reference):
        from repro_torch.core import OHHCTopology, SortEngine

        self.config, self.traffic, self.ref = config, traffic, reference
        topo = OHHCTopology(config["d_h"], config["variant"])
        if topo.total_procs != config["processors"]:
            raise ValueError(f"OHHC d_h={config['d_h']} has {topo.total_procs} processors, not {config['processors']}")
        self.eng = SortEngine(topo, host_threshold=config["host_threshold"], device=device)
        self.pool = generate.sort_pool(traffic, seed)
        self.keep = generate.kept(seed, traffic["check_every"])
        self.kept: list[tuple[int, np.ndarray]] = []

    def warm(self) -> None:
        """One request of every array of the pool, through both calls; each
        must take the path the configuration states."""
        for i, x in enumerate(self.pool):
            t0 = time.perf_counter()
            self.eng.sort(x)
            plan = self.eng.plan(x, self.eng.stats(x))
            self.eng.sort(x, plan=plan)
            print(f"warm-up: array {i} sorted twice in {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
            if plan.path != self.config["path"]:
                raise RuntimeError(f"the planner sent {x.size} keys to the {plan.path} path, not {self.config['path']}")

    def call(self, i: int, traced: bool, span) -> int:
        x = self.pool[i % len(self.pool)]
        if traced:
            with span("plan"):
                plan = self.eng.plan(x, self.eng.stats(x))
            with span("sort_call"):
                y = self.eng.sort(x, plan=plan)
        else:
            y = self.eng.sort(x)
        if next(self.keep):
            self.kept.append((i, y))
        return x.size

    def close(self) -> None:
        self.eng = None

    def check(self) -> dict:
        """Every kept answer against the reference's sort of its array."""
        want = [self.ref.sort(x) for x in self.pool]
        bad = sum(self.ref.mismatches(y, want[i % len(want)]) for i, y in self.kept)
        print(f"checked {len(self.kept)} answers of {self.traffic['keys']} keys against the reference", flush=True)
        return {"mismatched_keys": bad}


def readings(c: dict, seed: int, control: bool, faults: bool, device, calls: int = 8) -> dict:
    """One seed's readings for ``cardbench.readings``: ``calls`` requests
    through the cell's own calls, every answer kept and checked; the
    reference's control over the pool; an answer altered where it is
    produced."""
    from cardbench import run as harness

    ref = harness.load(c["reference"], "reference")
    traffic = dict(c["traffic"], check_every=1)
    out = {"seed": seed}
    spans = harness.Spans()

    def program(fault=None):
        cell = Cell(c["config"], traffic, seed, device, ref)
        if fault == "altered_answer":
            sort = cell.eng.sort

            def altered(x, **kw):
                y = sort(x, **kw)
                y[len(y) // 2] += 1
                return y

            cell.eng.sort = altered
        cell.warm()
        for i in range(calls):
            cell.call(i, i % 2 == 1, spans)
        cell.close()
        return cell.check()

    out["sound"] = program()
    if control:
        pool = generate.sort_pool(traffic, seed)
        out["control"] = {"mismatched_keys": sum(ref.mismatches(ref.control(x), ref.sort(x)) for x in pool)}
    if faults:
        out["fault.altered_answer"] = program("altered_answer")
    return out
