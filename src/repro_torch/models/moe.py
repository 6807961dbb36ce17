"""Mixture-of-Experts with sort-based dispatch: the paper's Array Division
Procedure applied to expert ids.

The port's copy of ``repro.models.moe``.  Each (token, expert-choice)
assignment is an element whose value is its expert id; bucketing the
assignments by expert id and laying each bucket out contiguously is the
paper's value-range partition (§3.1), and the merge-free gather becomes
the contiguous (expert, capacity) buffer the grouped FFN wants.

* ``dispatch='sorted'``: the histogram and the stable in-bucket ranks come
  from one ``ops.bucket_count_rank`` call, the count/rank kernel K1 on the
  card (its plain version on the CPU): one launch a layer a forward.
* ``dispatch='argsort'``: the same ranks from one stable ``torch.sort`` of
  the expert ids (position minus the expert's first position), as the
  reference takes them from ``jnp.argsort``; outputs are bit-identical to
  ``sorted``.
* ``dispatch='dense'``: every expert on every token (the numerics oracle).
* ``dispatch='shard_map'``: with no mesh the reference runs ``sorted``;
  so does the port.

The combine adds each token's k weighted expert outputs in choice order
(the reference's scatter-add order), so it is deterministic on the card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import AxisRules, Spec, dense_init, shard


def init_moe(gen: torch.Generator, cfg, *, lead: tuple[int, ...] = ()) -> dict:
    m = cfg.moe
    d, pd = cfg.d_model, cfg.param_dtype
    p = {
        "router": dense_init(gen, (d, m.num_experts), 0, pd, lead=lead),
        "wi": dense_init(gen, (m.num_experts, d, m.expert_d_ff), 1, pd, lead=lead),
        "wg": dense_init(gen, (m.num_experts, d, m.expert_d_ff), 1, pd, lead=lead),
        "wo": dense_init(gen, (m.num_experts, m.expert_d_ff, d), 1, pd, lead=lead),
    }
    if m.num_shared_experts:
        ff = m.shared_d_ff * m.num_shared_experts
        p["shared_wi"] = dense_init(gen, (d, ff), 0, pd, lead=lead)
        p["shared_wg"] = dense_init(gen, (d, ff), 0, pd, lead=lead)
        p["shared_wo"] = dense_init(gen, (ff, d), 0, pd, lead=lead)
    return p


def moe_specs(cfg, tp_size: int) -> dict:
    """Experts on the tensor axis when their count divides it (expert
    parallelism), else each expert's hidden width."""
    m = cfg.moe
    if m.num_experts % max(tp_size, 1) == 0 and tp_size > 1:
        e_wi, e_wo = Spec("tensor", "fsdp", None), Spec("tensor", None, "fsdp")
    else:
        e_wi, e_wo = Spec(None, "fsdp", "tensor"), Spec(None, "tensor", "fsdp")
    s = {"router": Spec("fsdp", None), "wi": e_wi, "wg": e_wi, "wo": e_wo}
    if m.num_shared_experts:
        s["shared_wi"] = Spec("fsdp", "tensor")
        s["shared_wg"] = Spec("fsdp", "tensor")
        s["shared_wo"] = Spec("tensor", "fsdp")
    return s


def _router(p, x, cfg):
    """Top-k routing: probs, expert ids (int32), aux load-balance loss.

    ``jax.lax.top_k`` puts the lower expert id first among equal
    probabilities; a stable descending sort does the same.
    """
    m = cfg.moe
    logits = torch.einsum("bsd,de->bse", x, p["router"].to(cfg.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p = srt.values[..., : m.num_experts_per_tok]
    top_e = srt.indices[..., : m.num_experts_per_tok].to(torch.int32)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch-style aux loss: E · Σ_e f_e · P_e
    token_frac = F.one_hot(top_e.long(), m.num_experts).to(torch.float32).sum(2).mean(dim=(0, 1))
    token_frac = token_frac / m.num_experts_per_tok
    prob_frac = probs.mean(dim=(0, 1))
    aux = m.num_experts * torch.sum(token_frac * prob_frac) * m.router_aux_loss
    return top_p, top_e, aux


def _expert_ffn(p, xs, cfg):
    """Grouped FFN over the (E, C, d) dispatch buffer."""
    dt = cfg.dtype
    h = torch.einsum("ecd,edf->ecf", xs, p["wi"].to(dt))
    g = torch.einsum("ecd,edf->ecf", xs, p["wg"].to(dt))
    return torch.einsum("ecf,efd->ecd", F.silu(g) * h, p["wo"].to(dt))


def capacity(num_assignments: int, cfg) -> int:
    """Slots an expert: ``ceil(A·cf / E)`` rounded up to a multiple of 8."""
    m = cfg.moe
    cap = int(-(-num_assignments * m.capacity_factor // m.num_experts))
    return cap + (-cap) % 8


def _ranks(flat_e: torch.Tensor, cfg) -> torch.Tensor:
    """Stable rank of each assignment among those of its expert."""
    E = cfg.moe.num_experts
    if cfg.moe.dispatch == "argsort":
        # one stable sort groups the assignments by expert; a rank is the
        # position minus the expert's first position
        srt = torch.sort(flat_e, stable=True)
        starts = torch.searchsorted(srt.values, torch.arange(E, dtype=flat_e.dtype, device=flat_e.device))
        ranks = torch.empty_like(flat_e)
        ranks[srt.indices] = (
            torch.arange(flat_e.shape[0], dtype=torch.int32, device=flat_e.device)
            - starts[srt.values.long()].to(torch.int32)
        )
        return ranks
    # Array Division: histogram + stable rank per bucket, one K1 call
    _counts, ranks = ops.bucket_count_rank(flat_e, E)
    return ranks


def apply_moe(p, x, cfg, rules: AxisRules):
    """Returns (y, aux_loss).  x: (B, S, d)."""
    m = cfg.moe
    B, S, d = x.shape
    top_p, top_e, aux = _router(p, x, cfg)

    if m.dispatch == "dense":
        # oracle path: every expert runs on every token
        gates = (F.one_hot(top_e.long(), m.num_experts).to(torch.float32) * top_p[..., None]).sum(2)
        h = torch.einsum("bsd,edf->bsef", x, p["wi"].to(cfg.dtype))
        g = torch.einsum("bsd,edf->bsef", x, p["wg"].to(cfg.dtype))
        y = torch.einsum("bsef,efd->bsed", F.silu(g) * h, p["wo"].to(cfg.dtype))
        y = torch.einsum("bsed,bse->bsd", y.to(torch.float32), gates).to(cfg.dtype)
    elif m.dispatch == "shard_map":
        # no mesh: the reference's fallback, the same math as 'sorted'
        cfg2 = cfg.replace(moe=dataclasses.replace(m, dispatch="sorted"))
        return apply_moe(p, x, cfg2, rules)  # incl. shared experts
    elif m.dispatch in ("sorted", "argsort"):
        T, k, E = B * S, m.num_experts_per_tok, m.num_experts
        A = T * k  # total assignments
        cap = capacity(A, cfg)
        flat_e = top_e.reshape(A)  # assignment → expert id ("value" to bucket)
        ranks = _ranks(flat_e, cfg)
        keep = ranks < cap
        slot = torch.where(keep, flat_e.long() * cap + ranks, E * cap)
        # dispatch buffer (E*C, d): token vectors in bucket order; the
        # dropped assignments all land in one spare row past the end
        tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
        buf = torch.zeros((E * cap + 1, d), dtype=cfg.dtype, device=x.device)
        buf[slot] = x.reshape(T, d)[tok_idx]
        ye = _expert_ffn(p, buf[:-1].view(E, cap, d), cfg).reshape(E * cap, d)
        contrib = torch.cat([ye, ye.new_zeros((1, d))])[slot].to(torch.float32)
        contrib = (contrib * top_p.reshape(A, 1)).view(T, k, d)
        # combine: each token's k choices added in order, from zero
        y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
        for j in range(k):
            y = y + contrib[:, j]
        y = y.reshape(B, S, d).to(cfg.dtype)
    else:
        raise ValueError(f"unknown dispatch {m.dispatch!r}")

    if m.num_shared_experts:
        dt = cfg.dtype
        h = torch.einsum("bsd,df->bsf", x, p["shared_wi"].to(dt))
        g = torch.einsum("bsd,df->bsf", x, p["shared_wg"].to(dt))
        y = y + torch.einsum("bsf,fd->bsd", F.silu(g) * h, p["shared_wo"].to(dt))
    y = shard(y, rules, "batch", "seq", None)
    return y, aux
