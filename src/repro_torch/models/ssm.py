"""Mamba2 (SSD, state-space duality) blocks: a chunked scan and an O(1) decode.

The port's copy of ``repro.models.ssm``.  Within a chunk of ``chunk_size``
positions the recurrence is materialised as a masked, decayed
attention-like quadratic; across chunks only the (heads, head_dim,
d_state) states flow, through a Python loop over the chunks (the
reference's ``lax.scan``).  Decode is one state update: no KV cache.

Block layout as in mamba2: in_proj → [z | xBC | dt], a causal depthwise
conv over xBC, SSD over (x, B, C) with per-head A and D, a gated RMSNorm,
out_proj.  The SSD arithmetic is float32, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import AxisRules, Spec, const_init, dense_init, shard


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


def _split_proj(proj, cfg):
    d_inner, _, conv_dim = _dims(cfg)
    return torch.split(proj, [d_inner, conv_dim, proj.shape[-1] - d_inner - conv_dim], dim=-1)


def _split_xbc(xBC, cfg):
    s = cfg.ssm
    d_inner = cfg.d_inner
    gs = s.n_groups * s.d_state
    return torch.split(xBC, [d_inner, gs, xBC.shape[-1] - d_inner - gs], dim=-1)


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
    """
    s = cfg.ssm
    d_inner, nh, _ = _dims(cfg)
    hd = s.head_dim
    proj = torch.einsum("bsd,de->bse", x, p["in_proj"].to(cfg.dtype))
    z, xBC, dt_raw = _split_proj(proj, cfg)
    A = -torch.exp(p["A_log"].to(torch.float32))
    Bt, S = x.shape[0], x.shape[1]
    D = p["D"].to(torch.float32)
    if cache is None or S > 1:
        # train (no cache) or prefill (fills the cache)
        xBC, conv_tail = _causal_conv(
            xBC, p["conv_w"].to(cfg.dtype), p["conv_b"].to(cfg.dtype), cfg,
            state=None if cache is None else cache["conv"],
        )
        xs, B_, C = _split_xbc(xBC, cfg)
        xs = xs.reshape(Bt, S, nh, hd)
        B_ = B_.reshape(Bt, S, s.n_groups, s.d_state)
        C = C.reshape(Bt, S, s.n_groups, s.d_state)
        dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"].to(torch.float32))
        y, final = ssd_chunked(xs, dt, A, B_, C, cfg, init_state=None if cache is None else cache["ssm"])
        y = y + xs.to(torch.float32) * D[None, None, :, None]
        new_cache = None if cache is None else {"conv": conv_tail, "ssm": final}
    else:
        # one step: update the conv state and the SSM state
        xp = torch.cat([cache["conv"], xBC], dim=1)  # (B, W, conv)
        conv_out = torch.einsum("bwc,wc->bc", xp, p["conv_w"].to(cfg.dtype)) + p["conv_b"].to(cfg.dtype)
        xs, B_, C = _split_xbc(F.silu(conv_out), cfg)
        xs = xs.reshape(Bt, nh, hd).to(torch.float32)
        rep = nh // s.n_groups
        Bh = B_.reshape(Bt, s.n_groups, s.d_state).to(torch.float32).repeat_interleave(rep, dim=1)  # (B,nh,ds)
        Ch = C.reshape(Bt, s.n_groups, s.d_state).to(torch.float32).repeat_interleave(rep, dim=1)
        dt = F.softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"].to(torch.float32))  # (B,nh)
        y, st = ssd_step(cache["ssm"], xs, dt, A, Bh, Ch)
        y = y + xs * D[None, :, None]
        new_cache = {"conv": xp[:, 1:], "ssm": st}
    y = y.reshape(Bt, S, d_inner).to(cfg.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    gf = (y * F.silu(z)).to(torch.float32)
    g = (gf * torch.rsqrt(gf.square().mean(-1, keepdim=True) + 1e-6)).to(cfg.dtype) * p["norm_scale"].to(cfg.dtype)
    out = torch.einsum("bse,ed->bsd", g, p["out_proj"].to(cfg.dtype))
    return shard(out, rules, "batch", "seq", None), new_cache


def init_mamba_cache(cfg, batch: int, dtype, device, *, lead: tuple[int, ...] = ()) -> dict:
    s = cfg.ssm
    _, nh, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((*lead, batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, batch, nh, s.head_dim, s.d_state), dtype=torch.float32, device=device),
    }
