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
* ``dispatch='dense'``: every expert on every token (the numerics oracle);
  under a mesh one region over the rows, each rank a ``d_ff`` slice of
  every expert, the slices' partial sums reduced (``_dense_on_mesh``).
* ``dispatch='shard_map'``: the reference's ``_moe_shard_map``.  Tokens
  never leave their rank: each rank runs the Array Division (K1) on its
  own tokens' assignments with the local capacity ``T_loc·k·cf/E``
  rounded up to 8, holds a ``d_ff`` slice of every expert (its tensor
  rank's), and one all-reduce over the tensor axis sums the slices.  The
  body is ``local_map`` over the ambient mesh and shares ``_dispatch``
  with ``sorted``.  With no mesh, no tensor axis, or a batch the batch
  axes do not divide, it runs ``sorted``, as the reference does.

Under a mesh ``sorted`` and ``argsort`` run as the reference's pjit
dispatch: the tokens and their routes are gathered whole, every rank
ranks all assignments (K1 on its replicated copy), and the dispatch
buffer and the expert outputs take the reference's constraints.

The combine adds each token's k weighted expert outputs in choice order
(the reference's scatter-add order), so it is deterministic on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (
    NO_SHARD,
    AxisRules,
    Spec,
    axes_of,
    batch_shards,
    dense_init,
    get_ambient_mesh,
    mesh_for,
    placements,
    region,
    replicated,
    shard,
    spec_axes,
    tp_region,
    tp_spec,
)


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


def _route(p, x, cfg):
    """Top-k routing: probs, expert ids (int32), and the two means of the
    aux loss (each expert's share of the assignments and of the probs).

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
    token_frac = F.one_hot(top_e.long(), m.num_experts).to(torch.float32).sum(2).mean(dim=(0, 1))
    token_frac = token_frac / m.num_experts_per_tok
    prob_frac = probs.mean(dim=(0, 1))
    return top_p, top_e, token_frac, prob_frac


def _router(p, x, cfg, rules: AxisRules = NO_SHARD):
    """Top-k routing: probs, expert ids (int32), aux load-balance loss.

    Under a mesh one region routes each rank's tokens; the two means of
    the aux loss are partial sums over the batch axes and the axes that
    split the sequence (each shard's mean over its equal share of the
    tokens), reduced before their product."""
    m = cfg.moe
    mesh = mesh_for(rules)
    if mesh is None:
        top_p, top_e, token_frac, prob_frac = _route(p, x, cfg)
    else:
        from repro_torch.runtime.ranks import mesh_sizes

        spec = axes_of(x, mesh)
        shards = tuple(rules.batch or ()) + spec_axes(spec[1])
        n = batch_shards(rules, mesh) * math.prod(mesh_sizes(mesh)[a] for a in spec_axes(spec[1]))

        def body(w, x):
            top_p, top_e, tf, pf = _route({"router": w}, x, cfg)
            return top_p, top_e, tf / n, pf / n

        top_p, top_e, token_frac, prob_frac = region(
            body, (p["router"].to(cfg.dtype), x), (tp_spec(p["router"], rules, mesh), spec),
            (spec, spec, Spec(), Spec()), partial=[(), (), shards, shards], mesh=mesh)
        token_frac, prob_frac = replicated(token_frac, mesh), replicated(prob_frac, mesh)
    # Switch-style aux loss: E · Σ_e f_e · P_e
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


def _slots(flat_e: torch.Tensor, ranks: torch.Tensor, cap: int, cfg):
    """(slot, keep) of every assignment: expert·cap + rank when the rank
    is under the capacity; a dropped assignment's slot is the spare row
    ``E·cap`` past the end."""
    keep = ranks < cap
    return torch.where(keep, flat_e.long() * cap + ranks, cfg.moe.num_experts * cap), keep


def _scatter(x: torch.Tensor, slot: torch.Tensor, cap: int, cfg) -> torch.Tensor:
    """The (E, cap, d) dispatch buffer: token vectors in bucket order."""
    T, d = x.shape[0] * x.shape[1], x.shape[-1]
    E, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((E * cap + 1, d), dtype=cfg.dtype, device=x.device)
    buf[slot] = x.reshape(T, d)[tok_idx]
    return buf[:-1].view(E, cap, d)


def _combine(ye: torch.Tensor, slot: torch.Tensor, top_p: torch.Tensor, cfg) -> torch.Tensor:
    """Each token's k weighted expert outputs added in choice order, from
    zero, in float32: (T, d)."""
    k, d = cfg.moe.num_experts_per_tok, ye.shape[-1]
    ye = ye.reshape(-1, d)
    A = slot.shape[0]
    T = A // k
    contrib = torch.cat([ye, ye.new_zeros((1, d))])[slot].to(torch.float32)
    contrib = (contrib * top_p.reshape(A, 1)).view(T, k, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=ye.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _dispatch(x, top_p, top_e, w, cap: int, cfg):
    """The Array Division dispatch of ``x``'s tokens at capacity ``cap``:
    ranks (one K1 call), buffer, grouped expert FFN, combine.  Returns
    (y (T, d) float32, keep (T·k,) bool).  ``sorted`` runs it on all the
    tokens, each rank of the ``shard_map`` dispatch on its own."""
    flat_e = top_e.reshape(-1)  # assignment → expert id ("value" to bucket)
    slot, keep = _slots(flat_e, _ranks(flat_e, cfg), cap, cfg)
    ye = _expert_ffn(w, _scatter(x, slot, cap, cfg), cfg)
    return _combine(ye, slot, top_p, cfg), keep


def local_capacity(B: int, S: int, rules: AxisRules, mesh, cfg) -> "int | None":
    """The ``shard_map`` dispatch's capacity for one rank's tokens, or
    ``None`` where the reference falls back to ``sorted``: no mesh, no
    tensor axis on it, or a batch the batch axes do not divide."""
    if mesh is None or rules.tensor not in mesh.mesh_dim_names:
        return None
    bsz = batch_shards(rules, mesh)
    if B % max(bsz, 1):
        return None
    return capacity((B // max(bsz, 1)) * S * cfg.moe.num_experts_per_tok, cfg)


def _split_on(w, dim: int, rules: AxisRules, mesh):
    """``w`` gathered whole first when its tensor-axis split lies on
    another dim than ``dim`` (experts stored split by expert, taken by
    ``d_ff``): the reshard XLA makes at the ``shard_map`` boundary, as an
    all-gather and a local slice."""
    spec = tp_spec(w, rules, mesh)
    if any(e is not None for j, e in enumerate(spec) if j != dim):
        return replicated(w, mesh)
    return w


def _moe_shard_map(p, x, cfg, rules: AxisRules, top_p, top_e):
    """The ``shard_map`` dispatch: tokens never leave their rank.  Each
    rank holds a ``d_ff`` slice of every expert, runs ``_dispatch`` on its
    own tokens at the local capacity, and one all-reduce over the tensor
    axis finishes the layer.  Returns y (B, S, d) in ``cfg.dtype`` laid out
    on the batch axes, or ``None`` under the reference's fallback
    conditions (``local_capacity``)."""
    mesh = get_ambient_mesh()
    B, S, d = x.shape
    cap = local_capacity(B, S, rules, mesh, cfg)
    if cap is None:
        return None
    t = rules.tensor
    bspec = Spec(rules.batch, None, None)
    # in the parameters' dtype while autograd records (the reference casts
    # inside the shard_map body, so the gradients are summed in it); without
    # it, cast first: the same values, gathered in half the bytes for bf16
    w = {k: p[k] if torch.is_grad_enabled() else p[k].to(cfg.dtype) for k in ("wi", "wg", "wo")}
    wi, wg = (_split_on(w[k], 2, rules, mesh) for k in ("wi", "wg"))
    wo = _split_on(w["wo"], 1, rules, mesh)

    def local(x_l, tp_l, te_l, wi, wg, wo):
        y, _ = _dispatch(x_l, tp_l, te_l, {"wi": wi, "wg": wg, "wo": wo}, cap, cfg)
        return y.view(x_l.shape)

    w_specs = (Spec(None, None, t), Spec(None, None, t), Spec(None, t, None))
    y = region(local, (x, top_p, top_e, wi, wg, wo), (bspec, bspec, bspec, *w_specs), (bspec,), partial=(t,),
               mesh=mesh)
    # d_ff is sliced over the tensor axis: one all-reduce sums the slices
    return y.redistribute(mesh, placements(bspec, mesh)).to(cfg.dtype)


def _expert_region(p, buf, rules: AxisRules, mesh, cfg):
    """The grouped expert FFN on the constrained dispatch buffer: by
    expert where the buffer is split by expert over the tensor axis, else
    by ``d_ff`` slice, the slices' partial sums left to the caller."""
    t = rules.tensor
    spec = axes_of(buf, mesh)
    if spec and spec[0] is not None:
        ws = [_split_on(p[k].to(cfg.dtype), 0, rules, mesh) for k in ("wi", "wg", "wo")]
        w_specs, partial = (Spec(t),) * 3, ()
    else:
        ws = [_split_on(p[k].to(cfg.dtype), j, rules, mesh) for k, j in (("wi", 2), ("wg", 2), ("wo", 1))]
        w_specs, partial = (Spec(None, None, t), Spec(None, None, t), Spec(None, t, None)), (t,)
    body = lambda buf, wi, wg, wo: _expert_ffn({"wi": wi, "wg": wg, "wo": wo}, buf, cfg)  # noqa: E731
    return region(body, (buf, *ws), (spec, *w_specs), (spec,), partial=partial, mesh=mesh)


def _sorted_on_mesh(p, x, cfg, rules: AxisRules, top_p, top_e, mesh):
    """``sorted``/``argsort`` under a mesh, as the reference's pjit
    dispatch: gathered tokens and routes, every assignment ranked on every
    rank (K1 or the stable sort on each rank's replicated copy), the
    reference's constraints on the buffer and the expert outputs, the
    combine on the gathered outputs."""
    m = cfg.moe
    B, S, d = x.shape
    cap = capacity(B * S * m.num_experts_per_tok, cfg)
    x, top_p, top_e = (replicated(a, mesh) for a in (x, top_p, top_e))
    flat_e = top_e.reshape(-1)
    ranks = region(lambda fe: _ranks(fe, cfg), (flat_e,), (Spec(),), (Spec(),), mesh=mesh)

    def scatter(x, fe, r):
        slot = _slots(fe, r, cap, cfg)[0]
        return _scatter(x, slot, cap, cfg), slot

    rep = (Spec(), Spec(), Spec())
    buf, slot = region(scatter, (x, flat_e, ranks), rep, (Spec(), Spec()), mesh=mesh)
    if m.dispatch_sharded:
        e_ax = "tensor" if m.expert_parallel else None
        buf = shard(buf, rules, e_ax, "batch", None)
        ye = shard(_expert_region(p, buf, rules, mesh, cfg), rules, e_ax, "batch", None)
    else:
        buf = shard(buf, rules, "tensor", None, None)
        ye = _expert_region(p, buf, rules, mesh, cfg)
    # the combine's index is data-dependent: the expert outputs are gathered
    y = region(lambda ye, s, tp: _combine(ye, s, tp, cfg).view(B, S, d), (replicated(ye, mesh), slot, top_p), rep,
               (Spec(),), mesh=mesh)
    return y.to(cfg.dtype).redistribute(mesh, placements(Spec(rules.batch, None, None), mesh))


def apply_moe(p, x, cfg, rules: AxisRules):
    """Returns (y, aux_loss).  x: (B, S, d)."""
    m = cfg.moe
    B, S, d = x.shape
    mesh = mesh_for(rules)
    top_p, top_e, aux = _router(p, x, cfg, rules)

    if m.dispatch not in ("dense", "sorted", "argsort", "shard_map"):
        raise ValueError(f"unknown dispatch {m.dispatch!r}")
    y = _moe_shard_map(p, x, cfg, rules, top_p, top_e) if m.dispatch == "shard_map" and mesh is not None else None
    if m.dispatch == "dense":
        y = _dense(p, x, top_p, top_e, cfg) if mesh is None else _dense_on_mesh(p, x, cfg, rules, top_p, top_e, mesh)
        y = y.to(cfg.dtype)
    elif y is None and mesh is not None:
        y = _sorted_on_mesh(p, x, cfg, rules, top_p, top_e, mesh)
    elif y is None:
        # 'shard_map' without a mesh is 'sorted', as in the reference
        y, _ = _dispatch(x, top_p, top_e, p, capacity(B * S * m.num_experts_per_tok, cfg), cfg)
        y = y.reshape(B, S, d).to(cfg.dtype)

    if m.num_shared_experts:
        if mesh is None:
            y = y + _shared(p, x, cfg)
        else:
            keys = ("shared_wi", "shared_wg", "shared_wo")
            sh = tp_region(lambda x, *w: _shared(dict(zip(keys, w)), x, cfg), x, [p[k].to(cfg.dtype) for k in keys],
                           rules, mesh)
            y = y + shard(sh, rules, "batch", "seq", None)
    y = shard(y, rules, "batch", "seq", None)
    return y, aux


def _dense(w, x, top_p, top_e, cfg):
    """The oracle: every expert on every token, the outputs weighted by
    the gates in float32: (B, S, d) float32."""
    E = cfg.moe.num_experts
    gates = (F.one_hot(top_e.long(), E).to(torch.float32) * top_p[..., None]).sum(2)
    h = torch.einsum("bsd,edf->bsef", x, w["wi"].to(cfg.dtype))
    g = torch.einsum("bsd,edf->bsef", x, w["wg"].to(cfg.dtype))
    y = torch.einsum("bsef,efd->bsed", F.silu(g) * h, w["wo"].to(cfg.dtype))
    return torch.einsum("bsed,bse->bsd", y.to(torch.float32), gates)


def _dense_on_mesh(p, x, cfg, rules: AxisRules, top_p, top_e, mesh):
    """The oracle over a mesh: one region over the rows of ``x`` (and their
    routes), laid out as ``x``.  Each rank holds a ``d_ff`` slice of every
    expert (``wi``/``wg`` by their last dim, ``wo`` by its middle one,
    gathered whole first where the experts are split by expert,
    ``_split_on``), and the output is a partial sum over the tensor axis,
    which the reference's GSPMD gives its einsums; where the tensor axis
    splits the rows (SP) the experts are taken whole and nothing is
    summed.  Returns y float32."""
    t = rules.tensor
    xs = axes_of(x, mesh)
    w = [p[k].to(cfg.dtype) for k in ("wi", "wg", "wo")]
    if t in spec_axes(xs):
        specs, partial = [Spec()] * 3, ()
    else:
        w = [_split_on(w[0], 2, rules, mesh), _split_on(w[1], 2, rules, mesh), _split_on(w[2], 1, rules, mesh)]
        specs, partial = [Spec(None, None, t), Spec(None, None, t), Spec(None, t, None)], (t,)

    def body(x, tp_, te_, wi, wg, wo):
        return _dense({"wi": wi, "wg": wg, "wo": wo}, x, tp_, te_, cfg)

    y = region(body, (x, top_p, top_e, *w), (xs, xs, xs, *specs), (xs,), partial=partial, mesh=mesh)
    return y.redistribute(mesh, placements(xs, mesh))


def _shared(p, x, cfg):
    dt = cfg.dtype
    h = torch.einsum("bsd,df->bsf", x, p["shared_wi"].to(dt))
    g = torch.einsum("bsd,df->bsf", x, p["shared_wg"].to(dt))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * h, p["shared_wo"].to(dt))
