"""Phase 15 (b) of ``chip_smoke.py`` run sound and with a fault planted in
its ranks, on one CUDA card: the readings that (b)'s limits are set
between.

    python3 tools/mesh_fault_readings.py [--faults tensor_allreduce,norm_per_rank,global_capacity]

The unsharded reference runs once (the 2-layer DeepSeek-V2-Lite's two
steps on one batch), then 4 ranks sharing the card over gloo run (b) once
sound and once for each fault.  A fault is patched into every rank's
modules before its step is built; the code on disk is not changed:

* ``tensor_allreduce``: the ``shard_map`` MoE dispatch's all-reduce over
  the tensor axis skipped (each rank's ``d_ff`` slice taken as the whole);
* ``norm_per_rank``: ``global_norm`` counting a replicated leaf once per
  rank, not once;
* ``global_capacity``: the ``shard_map`` dispatch at the capacity of all
  the tokens in place of one rank's.

Prints the card's name and power limit, then one JSON line a run: the
relative gaps ``chip_smoke.mesh_four_gaps`` reads, whether each passes
``chip_smoke.MESH_FOUR_GAP``, whether the ranks agree, and both sides'
losses and grad norms.  A run whose ranks raise is reported as such.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (exits without a card)
from repro_torch.runtime import ranks  # noqa: E402


def _skip_tensor_allreduce() -> None:
    from repro_torch.models import moe

    region = moe.region

    def unsummed(fn, args, in_specs, out_specs, *, partial=(), mesh=None):
        if fn.__qualname__.startswith("_moe_shard_map."):
            partial = ()  # the slices' partial sums declared whole: no all-reduce
        return region(fn, args, in_specs, out_specs, partial=partial, mesh=mesh)

    moe.region = unsummed


def _norm_per_rank() -> None:
    from repro_torch.optim import adamw

    adamw.replicas = lambda x: 1


def _global_capacity() -> None:
    from repro_torch.models import moe

    local_capacity = moe.local_capacity

    def global_capacity(B, S, rules, mesh, cfg):
        if local_capacity(B, S, rules, mesh, cfg) is None:
            return None
        return moe.capacity(B * S * cfg.moe.num_experts_per_tok, cfg)

    moe.local_capacity = global_capacity


FAULTS = {"tensor_allreduce": _skip_tensor_allreduce, "norm_per_rank": _norm_per_rank,
          "global_capacity": _global_capacity}


def faulty_rank(mesh, fault):
    if fault is not None:
        FAULTS[fault]()
    return chip_smoke.mesh_four_ranks(mesh)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", default=",".join(FAULTS), help="comma-separated, from " + ", ".join(FAULTS))
    faults = [f for f in ap.parse_args().faults.split(",") if f]
    unknown = sorted(set(faults) - set(FAULTS))
    if unknown:
        ap.error(f"unknown faults {unknown}")
    print("card:", chip_smoke.smi(), flush=True)
    cfg, run, batch = chip_smoke.mesh_four_model()
    ref = chip_smoke.unsharded_steps(cfg, run, [batch] * chip_smoke.MESH_FOUR_STEPS)
    del batch
    for fault in [None, *faults]:
        row = {"fault": fault or "none"}
        try:
            out = ranks.run_ranks(faulty_rank, chip_smoke.MESH_FOUR, chip_smoke.MESH_NAMES, backend="gloo",
                                  device="cuda", args=(fault,))
        except Exception as e:  # a rank raised: the fault stopped the step
            row["raised"] = f"{type(e).__name__}: {str(e)[-600:]}"
        else:
            metrics = out[0]["metrics"]
            gap = chip_smoke.mesh_four_gaps(metrics, ref)
            row.update(gap=gap, past_limit={k: not gap[k] <= lim for k, lim in chip_smoke.MESH_FOUR_GAP.items()},
                       ranks_agree=all(r["metrics"] == metrics for r in out),
                       loss=[m["loss"] for m in metrics], grad_norm=[m["grad_norm"] for m in metrics])
        row.update(ref_loss=[m["loss"] for m in ref], ref_grad_norm=[m["grad_norm"] for m in ref])
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
