"""Diagnostic: trace a small variant of a cell and print its largest
collectives and the ops that write the most bytes.

    PYTHONPATH=src python -m repro_torch.launch.diag --arch X --shape Y [--mesh single|multi] [--levers ...]

The port's copy of ``repro.launch.diag``.  The reference reads both lists
out of the optimized HLO; here the collectives are the dry-run's records
(``dryrun._collectives``) and the ops the trace's (one record per non-view
aten op, its result bytes and shapes).  Host-only, like the dry-run.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import math

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.dryrun import GRAD_ACCUM, LEVERS, _layer_period, _scaled_cfg, build_traced, run_traced
from repro_torch.launch.mesh import make_production_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--levers", default="")
    ap.add_argument("--layers", type=int, default=0, help="0 → one period")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch)
    run_kw = {}
    for lv in [x for x in args.levers.split(",") if x]:
        cfg, run_kw = LEVERS[lv](cfg, run_kw)
    run_kw.pop("_grad_specs", None)
    run_kw.pop("_grad_accum", None)
    shape = SHAPES[args.shape]
    mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    L1 = args.layers or _layer_period(cfg)
    cfg1 = _scaled_cfg(cfg, L1, scan=False)
    if shape.kind == "train":
        sizes = SH.mesh_axis_sizes(mesh)
        bs = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
        a_eff = max(1, min(GRAD_ACCUM.get(args.arch, 1), shape.global_batch // bs))
        shape = dataclasses.replace(shape, global_batch=shape.global_batch // a_eff)
    run = RunConfig(model=cfg1, shape=shape, grad_accum=1, **run_kw)
    traced, _ = build_traced(cfg1, shape, mesh, run)
    tr, _ = run_traced(traced, keep_ops=True)

    # ---- largest collectives
    colls = sorted(traced.collectives, key=lambda c: c.nbytes * c.count, reverse=True)
    print(f"=== top collectives ({L1} layers, A=1) — per-device output bytes")
    for c in colls[: args.top]:
        print(f"{c.nbytes * c.count / 1e6:10.1f} MB  {c.kind:18s} {c.count:5d} × {c.nbytes / 1e6:.2f} MB over "
              f"{','.join(c.axes)}: {c.what}")
    by_kind = collections.Counter()
    for c in colls:
        by_kind[c.kind] += c.nbytes * c.count
    total = sum(by_kind.values())
    print(f"total collective: {total/1e9:.2f} GB   by kind:", {k: f"{v/1e9:.2f}GB" for k, v in by_kind.items()})

    # ---- largest single ops by output bytes (traffic proxy)
    print("\n=== top non-view ops by output bytes")
    seen = collections.Counter()
    shown = 0
    for rec in sorted(tr.ops, key=lambda r: r.out_bytes, reverse=True):
        if seen[rec.op] >= 3:
            continue
        seen[rec.op] += 1
        print(f"{rec.out_bytes/1e6:10.1f} MB  {rec.op} -> {rec.shapes[:140]}")
        shown += 1
        if shown >= args.top:
            break

    mem = traced.memory(tr)
    print(f"\nflops={tr.flops:.3e}  bytes={tr.bytes:.3e}")
    print(f"temp={mem['temp_bytes']/1e9:.2f}GB arg={mem['argument_bytes']/1e9:.2f}GB")


if __name__ == "__main__":
    main()
