"""Mamba2 (SSD, state-space duality) blocks: a chunked scan and an O(1) decode.

The port's copy of ``repro.models.ssm``.  Within a chunk of ``chunk_size``
positions the recurrence is materialised as a masked, decayed
attention-like quadratic; across chunks only the (heads, head_dim,
d_state) states flow, through a Python loop over the chunks (the
reference's ``lax.scan``).  Decode is one state update: no KV cache.

Block layout as in mamba2: in_proj → [z | xBC | dt], a causal depthwise
conv over xBC, SSD over (x, B, C) with per-head A and D, a gated RMSNorm,
out_proj.  The SSD arithmetic is float32, as in the reference.

Over a mesh (``common.set_mesh``) the block is one region split by SSM
heads over the tensor axis (``_mamba_on_mesh``): each rank runs the conv
and the SSD on its own heads, the gated norm's mean of squares is summed
over the tensor axis, and ``out_proj``'s rows make a partial sum; a
sequence split over the tensor axis (SP) is gathered on entry and
reduce-scattered on exit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    AxisRules,
    Spec,
    axes_of,
    const_init,
    dense_init,
    gather_dim,
    mesh_for,
    region,
    scatter_sum_dim,
    shard,
    sum_over,
)


def _dims(cfg):
    s = cfg.ssm
    d_inner = cfg.d_inner
    nh = cfg.ssm_heads
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nh, conv_dim


def init_mamba(gen: torch.Generator, cfg, *, lead: tuple[int, ...] = ()) -> dict:
    s = cfg.ssm
    d_inner, nh, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + nh
    pd, dev = cfg.param_dtype, gen.device
    return {
        "in_proj": dense_init(gen, (cfg.d_model, d_in_proj), 0, pd, lead=lead),
        "conv_w": dense_init(gen, (s.d_conv, conv_dim), 0, pd, lead=lead),
        "conv_b": const_init(0.0, (conv_dim,), pd, dev, lead=lead),
        "A_log": const_init(0.0, (nh,), pd, dev, lead=lead),  # A = -exp(A_log) = -1
        "D": const_init(1.0, (nh,), pd, dev, lead=lead),
        "dt_bias": const_init(0.0, (nh,), pd, dev, lead=lead),
        "norm_scale": const_init(1.0, (d_inner,), pd, dev, lead=lead),
        "out_proj": dense_init(gen, (d_inner, cfg.d_model), 0, pd, lead=lead),
    }


def mamba_specs(cfg) -> dict:
    return {
        "in_proj": Spec("fsdp", "tensor"),
        "conv_w": Spec(None, "tensor"),
        "conv_b": Spec("tensor"),
        "A_log": Spec(None),
        "D": Spec(None),
        "dt_bias": Spec(None),
        "norm_scale": Spec("tensor"),
        "out_proj": Spec("tensor", "fsdp"),
    }


def _causal_conv(xBC, w, b, cfg, *, state=None):
    """Depthwise causal conv1d.  xBC: (B,S,C); w: (W,C).  Returns (y, new_state):
    the new state is the last W-1 rows of the padded input."""
    W, S = w.shape[0], xBC.shape[1]
    pad = xBC.new_zeros(xBC.shape[:1] + (W - 1,) + xBC.shape[2:]) if state is None else state
    xp = torch.cat([pad, xBC], dim=1)  # (B, S+W-1, C)
    y = xp[:, 0:S] * w[0]  # the reference's sum() adds the taps in this order
    for i in range(1, W):
        y = y + xp[:, i : i + S] * w[i]
    y = y + b
    new_state = xp[:, xp.shape[1] - (W - 1) :] if W > 1 else pad[:, :0]
    return F.silu(y), new_state


def _segsum(x):
    """log-space segment sums: out[..., i, j] = Σ_{k=j+1..i} x[..., k] (i ≥ j), else -inf."""
    T = x.shape[-1]
    xc = torch.cumsum(x, -1)
    diff = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, B_, C, cfg, *, init_state=None):
    """SSD over whole sequences.  Shapes:
    x (B,S,nh,hd) · dt (B,S,nh) · A (nh,) · B_/C (B,S,ng,ds).
    Returns (y (B,S,nh,hd) float32, final_state (B,nh,hd,ds) float32)."""
    Bt, S, nh, hd = x.shape
    ng, ds = B_.shape[2], B_.shape[3]
    Q = min(cfg.ssm.chunk_size, S)
    if S % Q:
        # zero-pad the tail: dt = 0 gives decay exp(0) = 1 and no
        # contribution, so the final state is exact; the padded outputs
        # are sliced off
        pad = Q - S % Q

        def zpad(a):
            return torch.cat([a, a.new_zeros((Bt, pad) + a.shape[2:])], dim=1)

        y, final = ssd_chunked(zpad(x), zpad(dt), A, zpad(B_), zpad(C), cfg, init_state=init_state)
        return y[:, :S], final
    nc = S // Q
    rep = nh // ng

    xf = x.to(torch.float32)
    dA = dt * A  # (B,S,nh), negative
    xc = xf.reshape(Bt, nc, Q, nh, hd)
    dtc = dt.reshape(Bt, nc, Q, nh)
    dAc = dA.reshape(Bt, nc, Q, nh).permute(0, 3, 1, 2)  # (B,nh,nc,Q)
    Bc = B_.to(torch.float32).reshape(Bt, nc, Q, ng, ds)
    Cc = C.to(torch.float32).reshape(Bt, nc, Q, ng, ds)

    dA_cum = torch.cumsum(dAc, -1)  # (B,nh,nc,Q)
    # ---- intra-chunk (quadratic, attention-like): the reference's
    # "bclhn,bcshn,bhcls,bcshp->bclhp", contracted C·B per group first, so
    # no intermediate outgrows the (B,nh,nc,Q,Q) decay matrix
    Lmat = torch.exp(_segsum(dAc))  # (B,nh,nc,Q,Q)
    xdt = xc * dtc[..., None]  # weight inputs by dt
    CB = torch.einsum("bclgn,bcsgn->bgcls", Cc, Bc).repeat_interleave(rep, dim=1)  # (B,nh,nc,Q,Q)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", CB * Lmat, xdt)
    # ---- chunk states
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)  # (B,nh,nc,Q)
    Bh = Bc.repeat_interleave(rep, dim=3)  # (B,nc,Q,nh,ds)
    states = torch.einsum("bclhn,bclhp->bchpn", Bh, xdt * decay_states.permute(0, 2, 3, 1)[..., None])
    # ---- inter-chunk recurrence over nc, emitting the state entering each chunk
    chunk_decay = torch.exp(dA_cum[..., -1])  # (B,nh,nc)
    carry = (
        torch.zeros((Bt, nh, hd, ds), dtype=torch.float32, device=x.device) if init_state is None else init_state
    )
    entry = []
    for c in range(nc):
        entry.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    entry_states = torch.stack(entry, dim=1)  # (B,nc,nh,hd,ds)
    # ---- contribution of the entering state to each position
    state_decay = torch.exp(dA_cum).permute(0, 2, 3, 1)  # (B,nc,Q,nh)
    Ch = Cc.repeat_interleave(rep, dim=3)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, entry_states) * state_decay[..., None]
    y = (y_diag + y_off).reshape(Bt, S, nh, hd)
    return y, carry


def ssd_step(state, x, dt, A, B_, C):
    """One SSD step, the decode update: state (B,nh,hd,ds) · x (B,nh,hd) ·
    dt (B,nh) · A (nh,) · B_/C (B,nh,ds), all float32.  Returns
    (y (B,nh,hd), new state); ``ssd_chunked`` is this applied position by
    position."""
    st = state * torch.exp(dt * A)[..., None, None] + torch.einsum("bh,bhp,bhn->bhpn", dt, x, B_)
    return torch.einsum("bhpn,bhn->bhp", st, C), st


def apply_mamba(p, x, cfg, rules: AxisRules, *, cache=None, pos=None):
    """Mamba2 block.  Train / prefill when ``cache`` is None or ``x`` holds
    more than one position; else one decode step.

    cache = {'conv': (B, W-1, conv_dim), 'ssm': (B, nh, hd, ds)}.
    Returns (y, new_cache or None); the cache given is left as it was.
    Under a mesh (``_mamba_on_mesh``) the block is split by SSM heads and
    writes the new states into the given cache's local shards instead,
    returning it.
    """
    mesh = mesh_for(rules)
    if mesh is not None:
        return _mamba_on_mesh(p, x, cfg, rules, mesh, cache)
    out, new_cache = _mamba_core(p, x, cfg, cache=cache)
    return shard(out, rules, "batch", "seq", None), new_cache


def _mamba_core(p, x, cfg, *, cache=None, mean_square=None):
    """The block up to its output's sharding constraint, on the heads whose
    weights ``p`` holds: ``in_proj``'s columns [z | x | B | C | dt] and
    ``conv_w``'s channels [x | B | C] of those heads and of the B/C groups
    they read, their ``A_log``, ``D``, ``dt_bias``, ``norm_scale`` entries
    and ``out_proj`` rows (all of them without a mesh).  ``mean_square``
    gives the gated norm's mean of squares over the whole d_inner from
    this share's float32 values (default: their own mean)."""
    s = cfg.ssm
    hd, ds = s.head_dim, s.d_state
    nh = p["A_log"].shape[-1]
    d_inner = nh * hd
    ng = (p["conv_w"].shape[-1] - d_inner) // (2 * ds)
    proj = torch.einsum("bsd,de->bse", x, p["in_proj"].to(cfg.dtype))
    z, xBC, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * ng * ds, nh], dim=-1)
    A = -torch.exp(p["A_log"].to(torch.float32))
    Bt, S = x.shape[0], x.shape[1]
    D = p["D"].to(torch.float32)
    if cache is None or S > 1:
        # train (no cache) or prefill (fills the cache)
        xBC, conv_tail = _causal_conv(
            xBC, p["conv_w"].to(cfg.dtype), p["conv_b"].to(cfg.dtype), cfg,
            state=None if cache is None else cache["conv"],
        )
        xs, B_, C = torch.split(xBC, [d_inner, ng * ds, ng * ds], dim=-1)
        xs = xs.reshape(Bt, S, nh, hd)
        B_ = B_.reshape(Bt, S, ng, ds)
        C = C.reshape(Bt, S, ng, ds)
        dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"].to(torch.float32))
        y, final = ssd_chunked(xs, dt, A, B_, C, cfg, init_state=None if cache is None else cache["ssm"])
        y = y + xs.to(torch.float32) * D[None, None, :, None]
        new_cache = None if cache is None else {"conv": conv_tail, "ssm": final}
    else:
        # one step: update the conv state and the SSM state
        xp = torch.cat([cache["conv"], xBC], dim=1)  # (B, W, conv)
        conv_out = torch.einsum("bwc,wc->bc", xp, p["conv_w"].to(cfg.dtype)) + p["conv_b"].to(cfg.dtype)
        xs, B_, C = torch.split(F.silu(conv_out), [d_inner, ng * ds, ng * ds], dim=-1)
        xs = xs.reshape(Bt, nh, hd).to(torch.float32)
        rep = nh // ng
        Bh = B_.reshape(Bt, ng, ds).to(torch.float32).repeat_interleave(rep, dim=1)  # (B,nh,ds)
        Ch = C.reshape(Bt, ng, ds).to(torch.float32).repeat_interleave(rep, dim=1)
        dt = F.softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"].to(torch.float32))  # (B,nh)
        y, st = ssd_step(cache["ssm"], xs, dt, A, Bh, Ch)
        y = y + xs * D[None, :, None]
        new_cache = {"conv": xp[:, 1:], "ssm": st}
    y = y.reshape(Bt, S, d_inner).to(cfg.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    gf = (y * F.silu(z)).to(torch.float32)
    ms = gf.square().mean(-1, keepdim=True) if mean_square is None else mean_square(gf)
    g = (gf * torch.rsqrt(ms + 1e-6)).to(cfg.dtype) * p["norm_scale"].to(cfg.dtype)
    out = torch.einsum("bse,ed->bsd", g, p["out_proj"].to(cfg.dtype))
    return out, new_cache


# ------------------------------------------------------------- over a mesh
def _share(cfg, rank: int, size: int) -> tuple[int, int, int, int]:
    """(first head, heads, first B/C group, groups) of one rank's share
    when the heads are split into ``size`` contiguous shares."""
    nh, ng = cfg.ssm_heads, cfg.ssm.n_groups
    k, rep = nh // size, nh // ng
    h0 = rank * k
    g0 = h0 // rep
    return h0, k, g0, (h0 + k - 1) // rep + 1 - g0


def _head_columns(cfg, rank: int, size: int) -> list[tuple[int, int]]:
    """``in_proj``'s columns of one rank's share, as (start, length) runs:
    z and x of its heads, B and C of their groups, dt of its heads."""
    d_inner, nh, _ = _dims(cfg)
    hd, ds, gs = cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.n_groups * cfg.ssm.d_state
    h0, k, g0, ng = _share(cfg, rank, size)
    return [(h0 * hd, k * hd), (d_inner + h0 * hd, k * hd), (2 * d_inner + g0 * ds, ng * ds),
            (2 * d_inner + gs + g0 * ds, ng * ds), (2 * d_inner + 2 * gs + h0, k)]


def _conv_channels(cfg, rank: int, size: int) -> list[tuple[int, int]]:
    """The conv's channels [x | B | C] of one rank's share: ``in_proj``'s
    x, B and C runs, less the z block before them."""
    d_inner = cfg.d_inner
    return [(a - d_inner, n) for a, n in _head_columns(cfg, rank, size)[1:4]]


def _take(w: torch.Tensor, runs: list, dim: int = -1) -> torch.Tensor:
    return torch.cat([w.narrow(dim, a, n) for a, n in runs], dim=dim)


def _mean_square(gf: torch.Tensor, group, d_inner: int) -> torch.Tensor:
    """The gated norm's mean of squares over the whole d_inner from each
    rank's channels: their sums of squares all-reduced over the tensor
    axis."""
    return sum_over(gf.square().sum(-1, keepdim=True), group) / d_inner


def _owned_channels(rank: int, width: int) -> int:
    """The first conv channel of a rank's shard of the conv cache."""
    return rank * width


def _conv_tail(w_in, x, conv, lo: int, cfg):
    """The conv state a block leaves in the conv cache's local shard
    (channels ``lo`` onwards): the last W-1 rows of its pre-conv inputs
    behind the state ``conv``, from ``x``'s last positions projected on
    ``in_proj``'s columns of those channels."""
    keep = cfg.ssm.d_conv - 1
    w = w_in.narrow(1, cfg.d_inner + lo, conv.shape[-1])
    xb = torch.einsum("bsd,de->bse", x[:, x.shape[1] - min(keep, x.shape[1]):], w)
    xp = torch.cat([conv, xb.to(conv.dtype)], dim=1)
    return xp[:, xp.shape[1] - keep:]


_MESH_KEYS = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale", "out_proj")


def _mamba_on_mesh(p, x, cfg, rules: AxisRules, mesh, cache):
    """The block as one region, split by SSM heads over the tensor axis.

    ``in_proj`` and the conv are gathered whole: their tensor-axis split
    runs over [z | x | B | C | dt] and does not follow the heads.  Each
    rank takes its heads' columns (and B and C of their groups, every
    head's with one group), runs the conv and the SSD on its heads only,
    takes the gated norm's mean of squares over the whole d_inner by an
    all-reduce of its sums over the tensor axis, and projects out with its
    rows of ``out_proj``: a partial sum over the tensor axis, reduced by
    ``shard``.  Under SP (``x`` split along its sequence over the tensor
    axis) the sequence is all-gathered on entry, since the conv and the
    chunked scan run along it, and the partial sums are reduce-scattered
    back to the sequence's shards on exit.

    With ``cache`` (its entries laid out by ``cache_specs``), each rank
    reads the conv state gathered over its channel shards and its heads'
    SSM state, and writes in place its heads' new SSM state and the new
    conv state of its own channel shard, those channels' inputs projected
    anew (``_conv_tail``).  Returns (y, cache)."""
    from repro_torch.runtime.ranks import gather_along, mesh_sizes

    tensor = rules.tensor
    tp = mesh_sizes(mesh).get(tensor, 1) if tensor else 1
    if cfg.ssm_heads % tp:
        raise ValueError(f"{cfg.ssm_heads} SSM heads do not split over the tensor axis of {tp}")
    group = mesh.get_group(tensor) if tp > 1 else None
    rank = mesh.get_local_rank(tensor) if tp > 1 else 0
    xs = axes_of(x, mesh)
    sp = xs[1] is not None
    if sp and (xs[1] != tensor or tp == 1):
        raise ValueError(f"the Mamba2 block takes a sequence split over the tensor axis only, not {xs}")
    ws = [p[k].to(torch.float32 if k in ("A_log", "D", "dt_bias") else cfg.dtype) for k in _MESH_KEYS]
    specs = [Spec()] * 6 + ([Spec(tensor), Spec(tensor, None)] if tp > 1 else [Spec(), Spec()])
    entries = [] if cache is None else [cache["conv"], cache["ssm"]]
    if entries and tp > 1 and axes_of(entries[1], mesh)[1] != tensor:
        raise ValueError(f"the SSM cache's heads are laid out {axes_of(entries[1], mesh)}, not split over {tensor!r}")
    conv_split = bool(entries) and tp > 1 and axes_of(entries[0], mesh)[-1] == tensor

    def body(x, *rest):
        w, entry = dict(zip(_MESH_KEYS, rest[: len(_MESH_KEYS)])), rest[len(_MESH_KEYS) :]
        if sp:
            x = gather_dim(x, 1, group)
        share, norm = w, None
        if tp > 1:
            h0, k, _, _ = _share(cfg, rank, tp)
            chans = _conv_channels(cfg, rank, tp)
            share = dict(w, in_proj=_take(w["in_proj"], _head_columns(cfg, rank, tp)),
                         conv_w=_take(w["conv_w"], chans), conv_b=_take(w["conv_b"], chans),
                         **{key: w[key].narrow(0, h0, k) for key in ("A_log", "D", "dt_bias")})
            norm = lambda gf: _mean_square(gf, group, cfg.d_inner)  # noqa: E731
        c = None
        if entry:
            conv, ssm_state = entry
            whole = gather_along(conv, conv.dim() - 1, group) if conv_split else conv
            c = {"conv": _take(whole, chans) if tp > 1 else whole, "ssm": ssm_state}
        out, new = _mamba_core(share, x, cfg, cache=c, mean_square=norm)
        if entry:
            ssm_state.copy_(new["ssm"])
            if tp > 1 or conv_split:
                lo = _owned_channels(rank, conv.shape[-1]) if conv_split else 0
                conv.copy_(_conv_tail(w["in_proj"], x, conv, lo, cfg))
            else:
                conv.copy_(new["conv"])
        if sp:
            out = scatter_sum_dim(out, 1, group)
        return out

    cspecs = [axes_of(e, mesh) for e in entries]
    out = region(body, (x, *ws, *entries), (xs, *specs, *cspecs), (xs,),
                 partial=(tensor,) if tp > 1 and not sp else (), mesh=mesh)
    return shard(out, rules, "batch", "seq", None), cache


def init_mamba_cache(cfg, batch: int, dtype, device, *, lead: tuple[int, ...] = ()) -> dict:
    s = cfg.ssm
    _, nh, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((*lead, batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, batch, nh, s.head_dim, s.d_state), dtype=torch.float32, device=device),
    }
