"""Generate the §Dry-run and §Roofline sections from the dry-run JSON cache.

    PYTHONPATH=src python -m repro_torch.roofline.gen_experiments [--dir experiments/dryrun_torch]

The port's copy of ``repro.roofline.gen_experiments``.  ``one_sentence``
keeps the reference's branches and names the H100's units (tensor cores,
NVLink, InfiniBand) where the reference names the TPU's MXU and ICI; the
§Roofline paragraph quotes the hardware record the cells were divided by.
"""

from __future__ import annotations

import argparse

from repro_torch.roofline.hw import H100, HW
from repro_torch.roofline.report import load_cells, record_of


def one_sentence(cell) -> str:
    """What would move the dominant term down."""
    r = cell["roofline"]
    dom = r["dominant"]
    shape = cell["shape"]
    if dom == "compute":
        return "compute-bound: raise tensor-core utilisation (larger per-device batch, fuse small einsums)"
    if dom == "memory":
        if "decode" in shape or "500k" in shape:
            return "KV/state streaming bound: shrink cache dtype (bf16→int8 KV) or shard cache seq further"
        return "HBM-bound: cut f32 attention intermediates / remat traffic (a fused flash-attention kernel on the card)"
    if r.get("coll_inter_bytes", 0) > r.get("coll_intra_bytes", 0):
        return "inter-pod bound: hierarchical (pod-aware) collectives; cross the InfiniBand tier once"
    return "NVLink-bound: halve gathered bytes (bf16 params/grads), defer DP reduce out of the microbatch loop"


def dryrun_section(cells) -> str:
    out = ["## §Dry-run", ""]
    out.append(
        "Every supported (arch × shape) traced as one device's share on fake tensors "
        "on both meshes (16×16 = 256-device pod; 2×16×16 = 512 devices, 'pod' = "
        "optical tier). Sharding rules per cell: batch axes / FSDP=data / TP=model, "
        "with SP (seq→model) when head counts don't divide TP and kv_seq sharding "
        "for cache-heavy decode. Per-cell JSON in experiments/dryrun_torch/."
    )
    out.append("")
    out.append("| arch | shape | mesh | compile s | HBM GB/dev | grad_accum | batch axes | heads | seq | kv_seq |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for c in cells:
        ru = c["rules"]
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['compile_s']} | "
            f"{c['memory_analysis']['total_bytes']/1e9:.2f} | {c.get('grad_accum',1)} | "
            f"{ru['batch']} | {ru['heads']} | {ru['seq']} | {ru['kv_seq']} |"
        )
    return "\n".join(out)


def roofline_section(cells, hw: HW = H100) -> str:
    out = ["## §Roofline", ""]
    out.append(
        f"Three terms per cell ({hw.name}: {hw.peak_bf16_flops / 1e12:.0f} TF/s bf16, "
        f"{hw.hbm_bw / 1e9:.0f} GB/s HBM, {hw.ici_bw / 1e9:.0f} GB/s intra-pod, "
        f"{hw.inter_pod_bw / 1e9:.0f} GB/s inter-pod), from CALIBRATED per-device "
        "costs (small unrolled variants reconstruct per-step FLOPs/bytes/"
        "collective traffic, the reference's algebra; see launch/dryrun.py).  "
        "MODEL_FLOPS = 6·N·D (train) or 2·N·D (serve), N = active params for MoE.  "
        "useful = MODEL_FLOPS / (traced FLOPs × devices).  roofline frac = "
        "ideal-compute time / bound-term time."
    )
    out.append("")
    for mesh in ("single", "multi"):
        out.append(f"### {mesh}-pod mesh")
        out.append("")
        out.append("| arch | shape | compute s | memory s | collective s (intra/inter GB) | dominant | useful | roofline frac | next lever |")
        out.append("|---|---|---|---|---|---|---|---|---|")
        for c in cells:
            if c["mesh"] != mesh or "roofline" not in c:
                continue
            r = c["roofline"]
            out.append(
                f"| {c['arch']} | {c['shape']} | {r['t_compute_s']:.2e} | "
                f"{r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} "
                f"({r['coll_intra_bytes']/1e9:.1f}/{r['coll_inter_bytes']/1e9:.1f}) | "
                f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
                f"{r['roofline_fraction']:.3f} | {one_sentence(c)} |"
            )
        out.append("")
    return "\n".join(out)


def variants_section(cells) -> str:
    out = ["### §Perf lever variants (baseline rows above; deltas in EXPERIMENTS.md §Perf)", ""]
    out.append("| arch | shape | mesh | levers | compute s | memory s | collective s | HBM GB/dev | roofline frac |")
    out.append("|---|---|---|---|---|---|---|---|---|")
    for c in cells:
        if "roofline" not in c:
            continue
        r = c["roofline"]
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {'+'.join(c['levers'])} | "
            f"{r['t_compute_s']:.2e} | {r['t_memory_s']:.2e} | "
            f"{r['t_collective_s']:.2e} | "
            f"{c['memory_analysis']['total_bytes']/1e9:.2f} | "
            f"{r['roofline_fraction']:.3f} |"
        )
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir)
    base = [c for c in cells if not c.get("levers")]
    tagged = [c for c in cells if c.get("levers")]
    print(dryrun_section(base))
    print()
    print(roofline_section(base, record_of(base)))
    print()
    print(variants_section(tagged))


if __name__ == "__main__":
    main()
