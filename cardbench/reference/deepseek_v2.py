"""Plain PyTorch reference of a DeepSeek-V2 training step, in float32.

Written from the configuration's equations (arXiv:2405.04434 §2 and the
configuration file beside the cell), not from the port, and importing
nothing of it.  Per layer:

    h  = rmsnorm(x) * ln1
    q  = h Wq (heads, nope | rope), c = h Wdkv, kr = rope(h Wkr)
    k  = [c Wuk | kr], v = c Wuv, a = softmax(q k^T / sqrt(dn + dr), causal) v Wo
    x  = x + a
    h2 = rmsnorm(x) * ln2
    p  = softmax(h2 Wr); the top-k experts of each token, their
         probabilities renormalised to sum to 1 (``norm_topk_prob``)
    an assignment (token t, choice j) is kept when fewer than
         ``capacity`` earlier assignments (in t-major, j-minor order)
         went to the same expert; ``capacity = ceil(T k cf / E)`` rounded
         up to a multiple of 8
    y  = sum_j p_tj [kept] FFN_e(h2) + FFN_shared(h2), FFN = (silu(h Wg) * h Wi) Wo
    x  = x + y
    aux = E * sum_e f_e P_e * alpha  (f_e: share of assignments, P_e: mean probability)

then logits = rmsnorm(x) * ln_f Wu, loss = mean(lse - logit_label +
z lse^2) + sum of the layers' aux, its gradient by autograd, and AdamW
with a global-norm clip.  Every product is float32 with TF32 off
(``precision="float32"``).  ``precision="fp8"`` is the step below the
configuration's bf16 compute, read beside the check: every matmul's
operands rounded to float8 (e4m3 forward, e5m2 for the incoming
gradient, a scale a tensor from its largest magnitude), the products and
the rest still float32.

Memory: each layer is recomputed in the backward, attention runs in
blocks of queries (each block only against the keys it can see) and the
loss in blocks of tokens, so a step of the 4-layer model at 8,192 tokens
fits beside its AdamW state on one 80 GB card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ATTN_BLOCK = 2048  # queries a block
LOSS_BLOCK = 4096  # tokens a block of the loss


# ----------------------------------------------------------------- weights
def weight_specs(c: dict) -> list[tuple[str, tuple, "float | None"]]:
    """``(name, shape, std)`` of every weight: normal with ``std =
    fan_in^-1/2``, or ones (``None``) for the norm scales.  Layers are
    stacked on a leading axis; the names follow the model's tree."""
    d, H, L, V = c["hidden_size"], c["num_attention_heads"], c["num_hidden_layers"], c["vocab_size"]
    r, dn, dr, dv = c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    E, f = c["n_routed_experts"], c["moe_intermediate_size"]
    fs = f * c["n_shared_experts"]
    if c["q_lora_rank"] or c["first_k_dense_replace"]:
        raise ValueError("this reference has no low-rank query and no dense leading layer")
    if (c.get("rope_scaling") or {}).get("factor", 1) > 1:
        raise ValueError("this reference has plain RoPE: YaRN only at factor 1, where it is the identity")
    s = lambda n: n ** -0.5  # noqa: E731
    return [
        ("embedding.embed", (V, d), s(d)),
        ("embedding.unembed", (d, V), s(d)),
        ("final_norm.scale", (d,), None),
        ("blocks.ln1.scale", (L, d), None),
        ("blocks.ln2.scale", (L, d), None),
        ("blocks.attn.wq", (L, d, H, dn + dr), s(d)),
        ("blocks.attn.wdkv", (L, d, r), s(d)),
        ("blocks.attn.wkr", (L, d, dr), s(d)),
        ("blocks.attn.wuk", (L, r, H, dn), s(r)),
        ("blocks.attn.wuv", (L, r, H, dv), s(r)),
        ("blocks.attn.wo", (L, H, dv, d), s(H * dv)),
        ("blocks.moe.router", (L, d, E), s(d)),
        ("blocks.moe.wi", (L, E, d, f), s(d)),
        ("blocks.moe.wg", (L, E, d, f), s(d)),
        ("blocks.moe.wo", (L, E, f, d), s(f)),
        ("blocks.moe.shared_wi", (L, d, fs), s(d)),
        ("blocks.moe.shared_wg", (L, d, fs), s(d)),
        ("blocks.moe.shared_wo", (L, fs, d), s(fs)),
    ]


def rule_leaves(c: dict) -> list[str]:
    """The weights a step moves by a rule and not by a gradient: none in
    DeepSeek-V2, whose every weight AdamW moves."""
    return []


# -------------------------------------------------------------- precision
def _q8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to float8 ``dtype`` with one scale for the tensor."""
    if not x.numel():
        return x
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Einsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eq, a, b):
        qa, qb = _q8(a, torch.float8_e4m3fn), _q8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        ctx.eq = eq
        return torch.einsum(eq, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        with torch.enable_grad():
            a = qa.detach().requires_grad_()
            b = qb.detach().requires_grad_()
            ga, gb = torch.autograd.grad(torch.einsum(ctx.eq, a, b), (a, b), _q8(g, torch.float8_e5m2))
        return None, ga, gb


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Einsum.apply(eq, a, b)
    return torch.einsum(eq, a, b)


# ------------------------------------------------------------------ model
def _rmsnorm(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def _rope(x, theta: float):
    """Rotate the two halves of the last axis of ``x`` (B, S, ..., hd) by
    position ``s`` times ``theta^(-2i/hd)``."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    shape = (1, S) + (1,) * (x.dim() - 3) + (hd // 2,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attn_block(q, k, v, start: int, precision: str):
    """Causal attention of the queries from ``start`` on over keys
    ``[0, start + len(q))``; ``q`` already carries the scale."""
    nq, nk = q.shape[1], k.shape[1]
    s = _mm("bqhe,bkhe->bhqk", q, k, precision)
    seen = torch.arange(nk, device=q.device)[None, :] <= (start + torch.arange(nq, device=q.device))[:, None]
    p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
    return _mm("bhqk,bkhe->bqhe", p, v, precision)


def _attention(w, h, c: dict, precision: str):
    dn, theta = c["qk_nope_head_dim"], c["rope_theta"]
    q = _mm("bsd,dhe->bshe", h, w["wq"], precision)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], theta)], -1)
    lat = _mm("bsd,dr->bsr", h, w["wdkv"], precision)
    kr = _rope(_mm("bsd,de->bse", h, w["wkr"], precision), theta)
    kn = _mm("bsr,rhe->bshe", lat, w["wuk"], precision)
    v = _mm("bsr,rhe->bshe", lat, w["wuv"], precision)
    k = torch.cat([kn, kr[:, :, None, :].expand(-1, -1, kn.shape[2], -1)], -1)
    q = q * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    S = h.shape[1]
    outs = []
    for a in range(0, S, ATTN_BLOCK):
        b = min(a + ATTN_BLOCK, S)
        outs.append(checkpoint(_attn_block, q[:, a:b], k[:, :b], v[:, :b], a, precision, use_reentrant=False))
    o = torch.cat(outs, 1)
    return _mm("bshe,hed->bsd", o, w["wo"], precision)


def _ffn(x, wi, wg, wo, precision: str):
    return _mm("tf,fd->td", F.silu(_mm("td,df->tf", x, wg, precision)) * _mm("td,df->tf", x, wi, precision),
               wo, precision)


def capacity(assignments: int, c: dict) -> int:
    cap = math.ceil(assignments * c["capacity_factor"] / c["n_routed_experts"])
    return cap + (-cap) % 8


def _moe(w, h, c: dict, precision: str):
    B, S, d = h.shape
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    x = h.reshape(B * S, d)
    T = x.shape[0]
    probs = torch.softmax(_mm("td,de->te", x, w["router"], precision), dim=-1)
    top_e = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[:, :k]
    top_p = torch.gather(probs, 1, top_e)
    if c["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = top_e.reshape(-1)
    onehot = F.one_hot(flat, E)
    aux = E * torch.sum(onehot.sum(0).to(torch.float32) / (T * k) * probs.mean(0)) * c["router_aux_loss"]
    rank = (onehot.cumsum(0) * onehot).sum(1) - 1
    kept = rank < capacity(T * k, c)
    del onehot, rank
    tok = torch.arange(T * k, device=h.device) // k
    gate = top_p.reshape(-1)
    toks, outs = [], []
    for e in range(E):
        sel = torch.nonzero((flat == e) & kept)[:, 0]
        toks.append(tok[sel])
        outs.append(_ffn(x[tok[sel]], w["wi"][e], w["wg"][e], w["wo"][e], precision) * gate[sel, None])
    y = torch.zeros_like(x).index_add(0, torch.cat(toks), torch.cat(outs))
    y = y + _ffn(x, w["shared_wi"], w["shared_wg"], w["shared_wo"], precision)
    return y.view(B, S, d), aux


_ATTN = ("wq", "wdkv", "wkr", "wuk", "wuv", "wo")
_MOE = ("router", "wi", "wg", "wo", "shared_wi", "shared_wg", "shared_wo")


def _layer(x, ln1, ln2, c, precision, *ws):
    attn = dict(zip(_ATTN, ws[: len(_ATTN)]))
    moe = dict(zip(_MOE, ws[len(_ATTN) :]))
    x = x + _attention(attn, _rmsnorm(x, ln1), c, precision)
    y, aux = _moe(moe, _rmsnorm(x, ln2), c, precision)
    return x + y, aux


def _loss_block(x, scale, unembed, labels, z: float, precision: str):
    logits = _mm("td,dv->tv", _rmsnorm(x, scale), unembed, precision)
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.sum(lse - ll + z * lse.square())


def loss_fn(W: dict, batch: dict, c: dict, precision: str = "float32") -> torch.Tensor:
    """The step's loss (cross-entropy, z-loss and the layers' aux) for the
    weights ``W`` (name -> tensor) on ``batch``."""
    L = c["num_hidden_layers"]
    tokens, labels = batch["tokens"], batch["labels"]
    x = W["embedding.embed"][tokens]
    keys = [f"blocks.attn.{n}" for n in _ATTN] + [f"blocks.moe.{n}" for n in _MOE]
    layers = {k: W[k].unbind(0) for k in keys}
    ln1, ln2 = W["blocks.ln1.scale"].unbind(0), W["blocks.ln2.scale"].unbind(0)
    aux = torch.zeros((), device=x.device)
    for i in range(L):
        ws = [layers[k][i] for k in keys]
        x, a = checkpoint(_layer, x, ln1[i], ln2[i], c, precision, *ws, use_reentrant=False)
        aux = aux + a
    d = x.shape[-1]
    x, labels = x.reshape(-1, d), labels.reshape(-1)
    T = x.shape[0]
    total = torch.zeros((), device=x.device)
    for a in range(0, T, LOSS_BLOCK):
        total = total + checkpoint(_loss_block, x[a : a + LOSS_BLOCK], W["final_norm.scale"],
                                   W["embedding.unembed"], labels[a : a + LOSS_BLOCK], c["z_loss"], precision,
                                   use_reentrant=False)
    return total / T + aux


# -------------------------------------------------------------- training
def lr_at(step: int, o: dict) -> float:
    """Linear warm-up to ``learning_rate`` over ``warmup_steps``, then a
    cosine to a tenth of it at ``total_steps``; ``step`` counts from 0."""
    peak, warm, total = o["learning_rate"], o["warmup_steps"], o["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))


def train(make_weight, batches: list, c: dict, precision: str = "float32") -> dict:
    """``len(batches)`` AdamW steps from the weights ``make_weight(name)``
    gives.  Returns the readings the check compares: each step's loss,
    each weight's first gradient norm before the clip (``grad``) and the
    norm of its change over all the steps (``change``), by name; and
    where ``rule_leaves`` names weights, their change tensors (``rule``)."""
    o = c["optimizer"]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        names = [n for n, _, _ in weight_specs(c)]
        W = {n: make_weight(n).requires_grad_() for n in names}
        m = {n: torch.zeros_like(W[n]) for n in names}
        v = {n: torch.zeros_like(W[n]) for n in names}
        losses, grad = [], {}
        for t, batch in enumerate(batches, start=1):
            loss = loss_fn(W, batch, c, precision)
            gs = torch.autograd.grad(loss, [W[n] for n in names])
            losses.append(float(loss.detach()))
            del loss
            norms = [float(torch.linalg.vector_norm(g)) for g in gs]
            if t == 1:
                grad = dict(zip(names, norms))
            gnorm = math.sqrt(sum(x * x for x in norms))
            scale = min(o["grad_clip"] / max(gnorm, 1e-9), 1.0)
            lr = lr_at(t - 1, o)
            b1, b2 = o["b1"], o["b2"]
            with torch.no_grad():
                for n, g in zip(names, gs):
                    g = g * scale
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    step = (m[n] / (1 - b1 ** t)) / ((v[n] / (1 - b2 ** t)).sqrt() + o["eps"])
                    W[n].sub_(lr * (step + o["weight_decay"] * W[n]))
            del gs
        del m, v
        change, rule, keep = {}, {}, set(rule_leaves(c))
        with torch.no_grad():
            for n in names:
                delta = W[n] - make_weight(n)
                change[n] = float(torch.linalg.vector_norm(delta))
                if n in keep:
                    rule[n] = delta.cpu()
                W[n] = None
        out = {"loss": losses, "grad": grad, "change": change}
        if rule:
            out["rule"] = rule
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
