"""The readings a cell's limits are set from, in one process on the card.

    python3 -m cardbench.readings --workload <name> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--out <file.jsonl>]

For each seed it calls ``readings`` of the cell's driver
(``drivers/<kind>.py``), which drives the cell's own set-up and timed
call as a run does and compares what they produced with the reference,
at the cell's sizes (``sound``).  On a control seed it also puts the
reference's lower-precision control in the program's place
(``control``); on a fault seed it plants each fault the cell can have in
the program's path and reads that (``fault.<name>``).  One JSON line a
seed; the limits in ``limits/<workload>.json`` sit between the sound
runs' largest reading and the least of the control's and the faults'.
Benchmark runs never call this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from cardbench import run as harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    flt = {int(s) for s in args.fault_seeds.split(",") if s}
    c = harness.cell(harness.ROOT, args.workload)
    device = torch.device(args.device)
    harness.use_program(c["root"])
    driver = harness.load(c["driver"], "driver")
    for seed in seeds:
        line = json.dumps({"workload": args.workload, **driver.readings(c, seed, seed in ctrl, seed in flt, device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
