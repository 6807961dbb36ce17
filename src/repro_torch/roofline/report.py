"""Aggregate dry-run JSONs into a roofline table.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun_torch] [--mesh single]

The port's copy of ``repro.roofline.report``: pure functions over the cell
dicts ``repro_torch.launch.dryrun`` writes (the reference's keys, so a
file from either package reads).  The "fits" column compares each cell's
per-device bytes with the hardware record's memory (80 GB on the H100)
where the reference compares with a fixed 16 GB, and its header names the
record: the one the cells name (``hw``), else the H100's.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.roofline.hw import H100, HW, RECORDS


def load_cells(d: str) -> list[dict]:
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                out.append(json.load(fh))
    return out


def record_of(cells: list[dict]) -> HW:
    """The hardware record the cells were divided by (the H100's for cells
    that name none)."""
    names = {c["hw"] for c in cells if "hw" in c}
    by_name = {hw.name: hw for hw in RECORDS.values()}
    if len(names) > 1:
        raise ValueError(f"cells divided by different records: {sorted(names)}")
    return by_name[names.pop()] if names else H100


def fmt_s(x: float) -> str:
    return f"{x:.2e}"


def markdown_table(cells: list[dict], mesh: str = "single", hw: HW = H100) -> str:
    cap = hw.hbm_bytes / 1e9
    rows = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        f"HBM GB/dev | fits {cap:.0f}G ({hw.name}) | useful FLOPs | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c["mesh"] != mesh or "roofline" not in c:
            continue
        r = c["roofline"]
        hbm = c["memory_analysis"]["total_bytes"] / 1e9
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['t_compute_s'])} | "
            f"{fmt_s(r['t_memory_s'])} | {fmt_s(r['t_collective_s'])} | "
            f"{r['dominant']} | {hbm:.1f} | {'yes' if hbm <= cap else 'NO'} | "
            f"{r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} |"
        )
    return "\n".join(rows)


def pick_hillclimb(cells: list[dict]) -> list[dict]:
    """worst roofline fraction / most collective-bound / most
    paper-representative (MoE with sort dispatch) among single-pod train/
    serve cells."""
    singles = [c for c in cells if c["mesh"] == "single" and "roofline" in c]
    worst = min(singles, key=lambda c: c["roofline"]["roofline_fraction"])
    coll = max(
        singles,
        key=lambda c: c["roofline"]["t_collective_s"] / max(c["roofline"]["bound_time_s"], 1e-12),
    )
    moes = [c for c in singles if c["arch"] in ("mixtral-8x22b", "deepseek-v2-lite-16b") and c["shape"] == "train_4k"]
    rep = moes[0] if moes else singles[0]
    return [worst, coll, rep]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir)
    print(markdown_table(cells, args.mesh, record_of(cells)))
    print()
    picks = pick_hillclimb(cells)
    print("hillclimb picks:", [(c["arch"], c["shape"], c["roofline"]["dominant"]) for c in picks])


if __name__ == "__main__":
    main()
