"""Roofline arithmetic: the three-term lower bound and the model FLOPs.

The port's copy of the arithmetic half of ``repro.roofline.analysis``
(``np_prod``, ``bound_time_s``, ``model_flops_for``), line for line:

    compute    = FLOPs             / peak_FLOP/s
    memory     = bytes             / HBM_bw
    collective = collective bytes  / link_bw   (per link class)

and the bound is the largest of the three.  The HLO half of the reference
(``collective_bytes``, ``roofline_from_compiled``, ``param_shape_set``)
reads a compiled dry-run artifact and waits for the dry-run slice
(ROADMAP.md, Queue 1, "Dry-run and roofline").
"""

from __future__ import annotations

from repro_torch.roofline.hw import HW, V5E


def np_prod(shp):
    n = 1
    for d in shp:
        n *= d
    return n


def bound_time_s(
    *,
    flops: float = 0.0,
    bytes_moved: float = 0.0,
    intra_pod_bytes: float = 0.0,
    inter_pod_bytes: float = 0.0,
    hw: HW = V5E,
) -> float:
    """Roofline lower bound on wall time for an abstract workload.

    The shared arithmetic behind the perf subsystem's machine
    normalisation (``repro_torch.perf.normalize``, DESIGN.md §9).
    """
    t_compute = flops / hw.peak_bf16_flops if flops else 0.0
    t_memory = bytes_moved / hw.hbm_bw if bytes_moved else 0.0
    t_coll = 0.0
    if intra_pod_bytes:
        t_coll += intra_pod_bytes / hw.ici_bw
    if inter_pod_bytes:
        t_coll += inter_pod_bytes / hw.inter_pod_bw
    return max(t_compute, t_memory, t_coll)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train; 2·N·D_active per generated token batch for
    decode; 2·N·D for prefill.  MoE uses active params."""
    n = cfg.param_count()
    if cfg.is_moe:
        m = cfg.moe
        total_e = 3 * cfg.d_model * m.expert_d_ff * m.num_experts
        active_e = 3 * cfg.d_model * m.expert_d_ff * m.num_experts_per_tok
        n = n - cfg.num_layers * (total_e - active_e)
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d_tokens
