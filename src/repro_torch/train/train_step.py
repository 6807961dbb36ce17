"""The training step: loss → grad → (optional compression) → AdamW.

The port's copy of ``repro.train.train_step``.  The step runs eagerly:
gradients come from ``torch.autograd.grad`` over the parameter leaves,
and AdamW writes the parameters and moments in place (the reference's
buffer donation), so peak memory stays at parameters + gradients +
moments; remat inside the model bounds activation memory.  The LR
schedule runs on the state's step tensor, as the reference's traced step.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.common import NO_SHARD, AxisRules, init_device, tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compress_grads, init_error_fb
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.train.loss import lm_loss

# microbatch split axis per input key ((3,B,S) positions are axis 1)
_MB_AXIS = {"positions_thw": 1}


def init_train_state(generator: torch.Generator, cfg: ModelConfig, run: RunConfig, model_api) -> dict:
    """Parameters drawn from ``generator`` on its device (meta tensors
    inside ``common.shapes_only()``), AdamW's state, the step; with
    ``master_weights`` the live parameters are bf16 and the float32 master
    lives in the optimizer state; with int8 compression, the
    error-feedback residual."""
    params = model_api.init(cfg, generator)
    opt = adamw_init(params)
    if run.master_weights:
        opt["master"] = tree_map(lambda p: p.to(torch.float32), params)
        params = tree_map(lambda p: p.to(torch.bfloat16), params)
    step = torch.zeros((), dtype=torch.int32, device=init_device(generator.device))
    state = {"params": params, "opt": opt, "step": step}
    if run.grad_compression == "int8":
        state["error_fb"] = init_error_fb(params)
    return state


def make_grad_fn(cfg: ModelConfig, run: RunConfig, model_api, rules: AxisRules = NO_SHARD):
    """``grads(params, batch) → (loss, metrics, aux, grads)``: the loss
    (with the MoE aux), the loss metrics, the aux and the gradient of
    every parameter leaf in ``tree_leaves`` order, averaged over
    ``run.grad_accum`` microbatches (summed in float32, then scaled by
    1/A, as the reference's scan)."""

    def one(params, batch):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            logits, aux = model_api.forward(tree_unflatten(params, live), batch, cfg, rules)
            loss, metrics = lm_loss(logits, batch["labels"])
            total = loss + aux
            del logits
            grads = torch.autograd.grad(total, live, allow_unused=True, materialize_grads=True)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, aux.detach(), list(grads)

    def grads(params, batch):
        A = run.grad_accum
        if A <= 1:
            return one(params, batch)

        def split(k, x, i):
            ax = _MB_AXIS.get(k, 0)
            return x.unflatten(ax, (A, x.shape[ax] // A)).select(ax, i)

        g32 = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in tree_leaves(params)]
        dev = g32[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        metrics = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in ("ce", "z_loss", "accuracy")}
        for i in range(A):
            l, m, a, g = one(params, {k: split(k, v, i) for k, v in batch.items()})
            for acc, gi in zip(g32, g):
                acc.add_(gi)
            loss, aux = loss + l, aux + a
            metrics = {k: metrics[k] + m[k] for k in metrics}
        inv = 1.0 / A
        return loss * inv, {k: v * inv for k, v in metrics.items()}, aux * inv, [g.mul_(inv) for g in g32]

    return grads


def make_train_step(cfg: ModelConfig, run: RunConfig, model_api, rules: AxisRules = NO_SHARD):
    """``train_step(state, batch) → (state, metrics)``.  The state is
    updated in place and returned; the metrics are 0-d tensors: ``loss``,
    ``aux``, ``lr``, ``ce``, ``z_loss``, ``accuracy``, ``grad_norm``,
    ``clip_scale``."""
    opt_cfg = AdamWConfig(weight_decay=run.weight_decay, grad_clip=run.grad_clip)
    grad_fn = make_grad_fn(cfg, run, model_api, rules)

    def train_step(state, batch):
        loss, metrics, aux, grads = grad_fn(state["params"], batch)
        grads = tree_unflatten(state["params"], grads)
        if run.grad_compression == "int8":
            grads, state["error_fb"] = compress_grads(grads, state["error_fb"])
        lr = cosine_warmup(state["step"], peak_lr=run.learning_rate, warmup=run.warmup_steps, total=run.total_steps)
        if run.master_weights:
            opt_metrics = adamw_update(state["opt"]["master"], grads, state["opt"], lr, opt_cfg)
            with torch.no_grad():
                for p, m in zip(tree_leaves(state["params"]), tree_leaves(state["opt"]["master"])):
                    p.copy_(m)
        else:
            opt_metrics = adamw_update(state["params"], grads, state["opt"], lr, opt_cfg)
        state["step"] += 1
        return state, {"loss": loss, "aux": aux, "lr": lr, **metrics, **opt_metrics}

    return train_step


def jit_train_step(train_step, mesh=None):
    """The reference jits the step with donated buffers; the port's step
    already runs eagerly in place, so it is returned as it is."""
    if mesh is not None:
        raise NotImplementedError(
            "a train step over a mesh (FSDP x TP on DTensor) waits for the model layer over a mesh "
            "(ROADMAP.md, Queue 1, 'Model layer over a mesh')"
        )
    return train_step
