"""``chip_smoke.py``'s gated mesh phases run sound and with a fault planted
in their ranks, on one CUDA card: the readings that their limits are set
between.

    python3 tools/mesh_fault_readings.py [--path train|serve|ssm|encdec|sp] [--faults a,b,...]

``--path train`` (the default) is phase 15 (b): the unsharded reference
runs once (the 2-layer DeepSeek-V2-Lite's two steps on one batch), then 4
ranks sharing the card over gloo run (b) once sound and once for each
fault.  ``--path serve`` is phase 16 (b) and (c): the ranks serve (b)'s
batch and (c)'s long prompt, and each run's logits are held to the
unsharded 2-layer model on the card fed that run's own tokens.  ``--path
ssm`` is phase 17 (b) and (c): the ranks train, prefill and serve the
cut mamba2-370m and Zamba2-2.7B, each run held to the same model
unsharded on the card.  ``--path encdec`` is phase 18 (b) and (c): the
ranks train and serve whisper-tiny (its batch-1 ``kv_seq`` request
included) and train qwen2-vl-7b and prefill its vision batch, each run
held to the same model unsharded on the card.  ``--path sp`` is phase
19 (b): the ranks train and serve whisper-tiny and train gemma3-4b under
sequence parallelism, each run held to the same model unsharded on the
card; phase 19 runs no vision tokens under SP, so the sound run and the
vision splice's fault also prefill qwen2-vl-7b (2 of 28 layers, 2 x
1,280 tokens, 1,024 vision tokens a row) under the production mesh's SP
rules, against the unsharded prefill.  A fault is patched into every
rank's modules before its model is built; the code on disk is not
changed:

* ``tensor_allreduce`` (train): the ``shard_map`` MoE dispatch's
  all-reduce over the tensor axis skipped (each rank's ``d_ff`` slice
  taken as the whole);
* ``norm_per_rank`` (train): ``global_norm`` counting a replicated leaf
  once per rank, not once;
* ``global_capacity`` (train): the ``shard_map`` dispatch at the capacity
  of all the tokens in place of one rank's;
* ``attn_allreduce`` (serve): the attention output's all-reduce over the
  tensor axis skipped (each rank's heads taken as the whole output);
* ``kv_seq_every_shard`` (serve): a ``kv_seq`` cache write landing on
  every shard (at the position's offset in each) instead of its owner's;
* ``lse_mean`` (serve): the log-sum-exp combine of the shards' attention
  replaced by the plain mean of their partial outputs;
* ``norm_own_channels`` (ssm): the Mamba2 gated norm's mean of squares
  over the rank's own channels, not all-reduced over the tensor axis;
* ``bc_contiguous`` (ssm): B and C read from the first columns of the
  rank's contiguous shard of ``in_proj``, not from B's and C's columns;
* ``conv_other_channels`` (ssm): the conv state written into the
  channels of the next rank's shard of the conv cache;
* ``sp_local_slice`` (ssm): under the sequence split, each rank keeping
  its own block of its partial sums in place of the reduce-scatter;
* ``cross_kv_other_heads`` (encdec): the cross-attention's K/V computed
  from another rank's heads' columns of ``wk`` / ``wv`` (both rolled by
  one rank's heads);
* ``kv_seq_without_combine`` (encdec): under ``kv_seq``, each rank's
  cross-attention over its own slice of the frames taken as the whole,
  without ``lse_combine``;
* ``thw_first_rows`` (encdec): every rank rotating by the M-RoPE
  positions of the global first rows, not its own;
* ``splice_first_rows`` (encdec): every rank splicing the vision
  embeddings of the global first rows over its own rows;
* ``q_offset_zero`` (sp): each rank's queries attending as if its chunk
  started the sequence (``q_offset`` 0 against the gathered keys);
* ``kv_not_gathered`` (sp): each rank attending over its own chunk's keys
  and values, not gathered along the sequence;
* ``positions_not_offset`` (sp): RoPE and whisper's sinusoid taken from
  position 0 on every rank's chunk;
* ``splice_on_every_rank`` (sp): every rank writing the vision
  embeddings from position 0 over its own chunk.

Prints the card's name and power limit, then one JSON line a run: the
gaps the phase reads, whether each passes its limits
(``chip_smoke.MESH_FOUR_GAP``, ``chip_smoke.MESH_SERVE_GAP``,
``chip_smoke.MESH_SSM_GAP`` and ``MESH_SSM_SERVE_GAP``,
``chip_smoke.MESH_ENCDEC_GAP`` and ``MESH_ENCDEC_SERVE_GAP``,
``chip_smoke.MESH_SP_GAP`` and ``MESH_SP_SERVE_GAP``), whether the
ranks agree, and the readings behind them.  A run whose ranks raise is
reported as such.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

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


def _skip_attn_allreduce() -> None:
    from repro_torch.models import common, lm, mla

    for mod in (common, lm, mla):  # prefill's regions through common.tp_region, decode's in lm and mla
        region = mod.region

        def unsummed(fn, args, in_specs, out_specs, *, partial=(), mesh=None, region=region):
            if "attn" in fn.__qualname__ or "mla" in fn.__qualname__:
                partial = [()] * len(partial) if isinstance(partial, list) else ()  # no all-reduce
            return region(fn, args, in_specs, out_specs, partial=partial, mesh=mesh)

        mod.region = unsummed


def _kv_seq_every_shard() -> None:
    from repro_torch.models import common, lm, mla

    def everywhere(dst, src, start, lo, total):
        common.put(dst, src.to(dst.dtype), (start - lo) % dst.shape[1])

    lm.put_owned = mla.put_owned = everywhere


def _lse_mean() -> None:
    from repro_torch.models import lm, mla
    from repro_torch.runtime.ranks import axis_group, gather_along

    def mean(out, lse, mesh, axes):
        n = math.prod(mesh.mesh.shape[mesh.mesh_dim_names.index(a)] for a in axes)
        parts = gather_along(out.to(torch.float32)[None], 0, axis_group(mesh, axes))
        return parts.view(n, *out.shape).mean(0)

    lm.lse_combine = mla.lse_combine = mean


def _ssm_norm_own_channels() -> None:
    from repro_torch.models import ssm

    ssm._mean_square = lambda gf, group, d_inner: gf.square().mean(-1, keepdim=True)


def _ssm_bc_contiguous() -> None:
    from repro_torch.models import ssm

    head_columns = ssm._head_columns

    def contiguous(cfg, rank, size):
        runs = head_columns(cfg, rank, size)
        width = (2 * cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state + cfg.ssm_heads) // size
        n = runs[2][1]
        return [runs[0], runs[1], (rank * width, n), (rank * width + n, n), runs[4]]

    ssm._head_columns = contiguous


def _ssm_conv_other_channels() -> None:
    from repro_torch.models import ssm

    owned, tp = ssm._owned_channels, chip_smoke.MESH_FOUR[2]
    ssm._owned_channels = lambda rank, width: owned((rank + 1) % tp, width)


def _ssm_sp_local_slice() -> None:
    import torch.distributed as dist

    from repro_torch.models import ssm

    ssm.scatter_sum_dim = lambda x, dim, group: x.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)]


def _encdec_cross_kv_other_heads() -> None:
    from repro_torch.models import common, encdec

    tp_region, tp = encdec.tp_region, chip_smoke.MESH_FOUR[2]

    def rolled(body, x, weights, rules, mesh, extra=(), inputs=(), **kw):
        if body.__qualname__.startswith("_cross_on_mesh"):
            weights = list(weights)
            for i in (1, 2):  # wk, wv
                w = weights[i]
                whole = torch.roll(common.whole(w), -(w.shape[1] // tp), 1)
                weights[i] = common.distribute(whole, common.axes_of(w, mesh), mesh)
        return tp_region(body, x, weights, rules, mesh, extra, inputs, **kw)

    encdec.tp_region = rolled


def _encdec_kv_seq_without_combine() -> None:
    from repro_torch.models import encdec

    encdec.lse_combine = lambda out, lse, mesh, axes: out


def _encdec_thw_first_rows() -> None:
    from repro_torch.models import common, lm

    tp_region = lm.tp_region

    def first_rows(body, x, weights, rules, mesh, extra=(), inputs=(), **kw):
        if inputs:  # M-RoPE's positions: the global first rows, as many as the rank's own
            (thw, _), rows = inputs[0], common.local(x).shape[0]
            inputs = ((common.whole(thw)[:, :rows].contiguous(), common.Spec()),)
        return tp_region(body, x, weights, rules, mesh, extra, inputs, **kw)

    lm.tp_region = first_rows


def _encdec_splice_first_rows() -> None:
    from repro_torch.models import common, lm

    region = lm.region

    def first_splice(fn, args, in_specs, out_specs, **kw):
        if fn is lm._splice:
            x, ve = args
            args, in_specs = (x, common.whole(ve)[: common.local(x).shape[0]].contiguous()), (in_specs[0], None)
        return region(fn, args, in_specs, out_specs, **kw)

    lm.region = first_splice


def _sp_q_offset_zero() -> None:
    from repro_torch.models import lm, mla

    for mod in (lm, mla):
        attention = mod.attention

        def at_zero(q, k, v, attention=attention, **kw):
            if k.shape[1] > q.shape[1] and kw.get("kv_len") is None and kw.get("k_positions") is None:
                kw["q_offset"] = 0
            return attention(q, k, v, **kw)

        mod.attention = at_zero


def _sp_kv_not_gathered() -> None:
    from repro_torch.models import lm, mla

    lm.gather_dim = mla.gather_dim = lambda x, dim, group: x


def _sp_positions_not_offset() -> None:
    from repro_torch.models import encdec, lm

    attn_core, seq_split = lm._attn_core, encdec.seq_split

    def from_zero(*a, **kw):
        if kw.get("seq_group") is not None and kw.get("positions") is not None:
            kw["positions"] = kw["positions"] - kw["q_offset"]
        return attn_core(*a, **kw)

    lm._attn_core = from_zero
    encdec.seq_split = lambda x, mesh: (*seq_split(x, mesh)[:1], 0, seq_split(x, mesh)[2])


def _sp_splice_on_every_rank() -> None:
    from repro_torch.models import lm

    region = lm.region

    def from_zero(fn, args, in_specs, out_specs, **kw):
        if fn is lm._splice and len(args) == 3:
            args = (*args[:2], 0)
        return region(fn, args, in_specs, out_specs, **kw)

    lm.region = from_zero


FAULTS = {"tensor_allreduce": _skip_tensor_allreduce, "norm_per_rank": _norm_per_rank,
          "global_capacity": _global_capacity}
SERVE_FAULTS = {"attn_allreduce": _skip_attn_allreduce, "kv_seq_every_shard": _kv_seq_every_shard,
                "lse_mean": _lse_mean}
SSM_FAULTS = {"norm_own_channels": _ssm_norm_own_channels, "bc_contiguous": _ssm_bc_contiguous,
              "conv_other_channels": _ssm_conv_other_channels, "sp_local_slice": _ssm_sp_local_slice}
ENCDEC_FAULTS = {"cross_kv_other_heads": _encdec_cross_kv_other_heads,
                 "kv_seq_without_combine": _encdec_kv_seq_without_combine,
                 "thw_first_rows": _encdec_thw_first_rows, "splice_first_rows": _encdec_splice_first_rows}
SP_FAULTS = {"q_offset_zero": _sp_q_offset_zero, "kv_not_gathered": _sp_kv_not_gathered,
             "positions_not_offset": _sp_positions_not_offset, "splice_on_every_rank": _sp_splice_on_every_rank}
SP_VISION = ("qwen2-vl-7b", 2, 2, 1280)  # (arch, layers, batch, sequence) of the vision prefill under SP
PATHS = {"train": FAULTS, "serve": SERVE_FAULTS, "ssm": SSM_FAULTS, "encdec": ENCDEC_FAULTS, "sp": SP_FAULTS}


def faulty_rank(mesh, fault):
    if fault is not None:
        FAULTS[fault]()
    return chip_smoke.mesh_four_ranks(mesh)


def faulty_serving_rank(mesh, fault):
    if fault is not None:
        SERVE_FAULTS[fault]()
    return chip_smoke.mesh_serve_four_ranks(mesh)


def faulty_ssm_rank(mesh, fault):
    if fault is not None:
        SSM_FAULTS[fault]()
    return chip_smoke.mesh_ssm_four_ranks(mesh)


def faulty_encdec_rank(mesh, fault):
    if fault is not None:
        ENCDEC_FAULTS[fault]()
    return chip_smoke.mesh_encdec_four_ranks(mesh)


def sp_vision_model():
    """The vision prefill's config and batch (``SP_VISION``), each row on
    its own M-RoPE grid."""
    arch, n_layers, B, S = SP_VISION
    cfg = chip_smoke.registry.get_config(arch).replace(num_layers=n_layers)
    batch = chip_smoke.SyntheticLMData(cfg, B, S, seed=0, device=chip_smoke.DEV).next_batch()
    return cfg, chip_smoke.vision_rows(cfg, batch)


def faulty_sp_rank(mesh, fault, phase: bool, vision: bool):
    if fault is not None:
        SP_FAULTS[fault]()
    out = chip_smoke.mesh_sp_four_ranks(mesh) if phase else {}
    if vision:
        cfg, batch = sp_vision_model()
        params = chip_smoke.lm.init(cfg, torch.Generator(device=chip_smoke.DEV).manual_seed(0))
        B, S = batch["tokens"].shape
        rules = chip_smoke.sp_rules(cfg, chip_smoke.ShapeConfig("prefill", S, B, "prefill"), mesh, serve=True)
        params = chip_smoke.lay_out(params, chip_smoke.sharding.param_layout(cfg, rules, mesh, params), mesh)
        out["vision"] = chip_smoke.mesh_vision_serve(mesh, cfg, params, batch, 1, prefill_rules=rules)
    return out


def sp_readings(faults: list) -> None:
    """Phase 19 (b) sound and under each SP fault but the splice's (phase
    19 runs no vision tokens): each arch's training gaps and whisper-tiny's
    serving gaps against the same model unsharded on the card; the sound
    run and the splice's fault also prefill qwen2-vl-7b's vision batch
    under SP and read its gaps against the unsharded model."""
    limits = {"train": chip_smoke.MESH_SP_GAP, "serve": chip_smoke.MESH_SP_SERVE_GAP}
    for fault in [None, *faults]:
        row = {"fault": fault or "none"}
        phase, vision = fault != "splice_on_every_rank", fault in (None, "splice_on_every_rank")
        try:
            out = ranks.run_ranks(faulty_sp_rank, chip_smoke.MESH_SP_FOUR, chip_smoke.MESH_NAMES, backend="gloo",
                                  device="cuda", args=(fault, phase, vision))
        except Exception as e:  # a rank raised: the fault stopped the run
            row["raised"] = f"{type(e).__name__}: {str(e)[-600:]}"
        else:
            if phase:
                for arch, got in chip_smoke.mesh_sp_readings(out).items():
                    got.pop("ref_train")
                    past = {k: not v <= limits["train"][arch][k] for k, v in got["train"].items()}
                    if "b" in got:
                        past["b"] = [k for k, lim in limits["serve"].items() if not got["b"][k] <= lim]
                    row[arch] = {"readings": got, "past_limit": past}
            if vision:
                cfg, batch = sp_vision_model()
                params = chip_smoke.lm.init(cfg, torch.Generator(device=chip_smoke.DEV).manual_seed(0))
                log = out[0]["vision"]["log"]
                inputs = {k: batch[k] for k in ("vision_embeds", "positions_thw")}
                tf = chip_smoke.teacher_forced(cfg, params, log, batch["tokens"].shape[1] + 1, inputs=inputs)
                gap = chip_smoke.logit_gaps(log, tf)
                row["vision"] = {"gap": gap, "rules": out[0]["vision"]["prefill_rules"],
                                 "past_limit": [k for k, lim in limits["serve"].items() if not gap[k] <= lim]}
                del params, batch
                torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)


def encdec_readings(faults: list) -> None:
    """Phase 18 (b) and (c) sound and under each encdec / vlm fault: each
    arch's training gaps and every serving run's logit gaps against the
    same model unsharded on the card."""
    limits = {"train": chip_smoke.MESH_ENCDEC_GAP, "serve": chip_smoke.MESH_ENCDEC_SERVE_GAP}
    for fault in [None, *faults]:
        row = {"fault": fault or "none"}
        try:
            out = ranks.run_ranks(faulty_encdec_rank, chip_smoke.MESH_FOUR, chip_smoke.MESH_NAMES, backend="gloo",
                                  device="cuda", args=(fault,))
        except Exception as e:  # a rank raised: the fault stopped the run
            row["raised"] = f"{type(e).__name__}: {str(e)[-600:]}"
        else:
            for arch, got in chip_smoke.mesh_encdec_readings(out).items():
                got.pop("ref_train")
                past = {k: not v <= limits["train"][k] for k, v in got["train"].items()}
                for case in ("b", "c"):
                    if case in got:
                        past[case] = [k for k, lim in limits["serve"].items() if not got[case][k] <= lim]
                row[arch] = {"readings": got, "past_limit": past,
                             "ranks_agree": all(r[arch]["b"]["tokens"] == out[0][arch]["b"]["tokens"] for r in out)}
        print(json.dumps(row), flush=True)


def ssm_readings(faults: list) -> None:
    """Phase 17 (b) and (c) sound and under each Mamba2 fault: each arch's
    training gaps, mamba2's prefill gap and every serving run's logit
    gaps against the same model unsharded on the card."""
    limits = {"train": chip_smoke.MESH_SSM_GAP, "serve": chip_smoke.MESH_SSM_SERVE_GAP}
    for fault in [None, *faults]:
        row = {"fault": fault or "none"}
        try:
            out = ranks.run_ranks(faulty_ssm_rank, chip_smoke.MESH_FOUR, chip_smoke.MESH_NAMES, backend="gloo",
                                  device="cuda", args=(fault,))
        except Exception as e:  # a rank raised: the fault stopped the run
            row["raised"] = f"{type(e).__name__}: {str(e)[-600:]}"
        else:
            for arch, got in chip_smoke.mesh_ssm_readings(out).items():
                got.pop("ref_train")
                past = {k: not got["train"][k] <= lim for k, lim in limits["train"].items()}
                if "prefill" in got:
                    past["prefill"] = not got["prefill"] <= limits["serve"]["prefill"]
                for case in ("b", "c"):
                    if case in got:
                        past[case] = [k for k, lim in limits["serve"].items() if not got[case][k] <= lim]
                row[arch] = {"readings": got, "past_limit": past,
                             "ranks_agree": all(r[arch]["b"]["tokens"] == out[0][arch]["b"]["tokens"] for r in out)}
        print(json.dumps(row), flush=True)


def serve_readings(faults: list) -> None:
    """Phase 16 (b) and (c) sound and under each serving fault, each run's
    logits against the unsharded model fed its own tokens."""
    cfg = chip_smoke.mesh_serve_model()
    params = chip_smoke.lm.init(cfg, torch.Generator(device=chip_smoke.DEV).manual_seed(0))
    for fault in [None, *faults]:
        row = {"fault": fault or "none"}
        try:
            out = ranks.run_ranks(faulty_serving_rank, chip_smoke.MESH_FOUR, chip_smoke.MESH_NAMES, backend="gloo",
                                  device="cuda", args=(fault,))
        except Exception as e:  # a rank raised: the fault stopped the run
            row["raised"] = f"{type(e).__name__}: {str(e)[-600:]}"
        else:
            for case, max_len in (("b", chip_smoke.SERVE_MAX_LEN), ("c", chip_smoke.MESH_SERVE_KV_MAX_LEN)):
                runs = [r[case] for r in out]
                ref = chip_smoke.teacher_forced(cfg, params, runs[0]["log"], max_len,
                                                chip_smoke.batch_groups(runs[0]["rules"][0]))
                gap = chip_smoke.logit_gaps(runs[0]["log"], ref)
                row[case] = {"gap": gap, "past_limit": {k: not gap[k] <= lim
                                                        for k, lim in chip_smoke.MESH_SERVE_GAP.items()},
                             "ranks_agree": all(r["tokens"] == runs[0]["tokens"] for r in runs)}
        print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=tuple(PATHS), default="train")
    ap.add_argument("--faults", default=None, help="comma-separated, from "
                    + ", ".join(f for path in PATHS.values() for f in path) + " (default: every fault of the path)")
    args = ap.parse_args()
    known = PATHS[args.path]
    faults = [f for f in (args.faults or ",".join(known)).split(",") if f]
    unknown = sorted(set(faults) - set(known))
    if unknown:
        ap.error(f"unknown faults {unknown} for --path {args.path}")
    print("card:", chip_smoke.smi(), flush=True)
    if args.path == "serve":
        serve_readings(faults)
        return
    if args.path == "ssm":
        ssm_readings(faults)
        return
    if args.path == "encdec":
        encdec_readings(faults)
        return
    if args.path == "sp":
        sp_readings(faults)
        return
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
