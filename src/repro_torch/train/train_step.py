"""The training step: loss → grad → (optional compression) → AdamW.

The port's copy of ``repro.train.train_step``.  The step runs eagerly:
gradients come from ``torch.autograd.grad`` over the parameter leaves,
and AdamW writes the parameters and moments in place (the reference's
buffer donation), so peak memory stays at parameters + gradients +
moments; remat inside the model bounds activation memory.  The LR
schedule runs on the state's step tensor, as the reference's traced step.

Over a mesh (``jit_train_step(step, mesh, state_specs, batch_specs)``,
one process a device) the state and the batch are DTensors laid out by
their specs, the model runs under ``common.set_mesh`` (FSDP × TP, as the
reference's GSPMD partitions its jitted step), the gradients come back in
their parameters' layouts (the backward of each FSDP gather is a
reduce-scatter), and the optimizer updates each shard where it lies.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.common import (
    NO_SHARD,
    AxisRules,
    Spec,
    get_ambient_mesh,
    init_device,
    is_dtensor,
    lay_out,
    local,
    mesh_zeros,
    placements,
    relaid,
    replicated,
    set_mesh,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
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


def make_grad_fn(cfg: ModelConfig, run: RunConfig, model_api, rules: AxisRules = NO_SHARD, grad_specs=None):
    """``grads(params, batch) → (loss, metrics, aux, grads)``: the loss
    (with the MoE aux), the loss metrics, the aux and the gradient of
    every parameter leaf in ``tree_leaves`` order, averaged over
    ``run.grad_accum`` microbatches (summed in float32, then scaled by
    1/A, as the reference's scan).  Over a mesh each microbatch's
    gradients are redistributed to ``grad_specs`` (a ``Spec`` tree like
    the parameters'; ``None`` leaves them in their parameters' layouts)."""

    def constrain(params, grads):
        # a gradient may come back as a partial sum: reduce it into its
        # parameter's layout, then into grad_specs' where one is given
        mesh = get_ambient_mesh()
        if mesh is None or not is_dtensor(grads[0]):
            return grads
        grads = [relaid(g, p.placements, mesh) for g, p in zip(grads, tree_leaves(params))]
        if grad_specs is None:
            return grads
        return tree_leaves(_constrain(tree_unflatten(params, grads), grad_specs, mesh))

    def one(params, batch):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        dev = live[0].device
        with torch.enable_grad():
            with tracing.span("train.forward", device=dev):
                logits, aux = model_api.forward(tree_unflatten(params, live), batch, cfg, rules)
                loss, metrics = lm_loss(logits, batch["labels"])
                total = loss + aux
                del logits
            with tracing.span("train.backward", device=dev):
                grads = torch.autograd.grad(total, live, allow_unused=True, materialize_grads=True)
                grads = constrain(params, list(grads))
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, aux.detach(), grads

    def grads(params, batch):
        A = run.grad_accum
        if A <= 1:
            return one(params, batch)

        def split(k, x, i):
            # microbatch i is global rows [i·B/A, (i+1)·B/A), as the
            # reference's reshape; over a mesh the batch is gathered first
            ax = _MB_AXIS.get(k, 0)
            x = replicated(x) if is_dtensor(x) else x
            return x.unflatten(ax, (A, x.shape[ax] // A)).select(ax, i)

        mesh = get_ambient_mesh() if is_dtensor(tree_leaves(params)[0]) else None
        dev = tree_leaves(params)[0].device
        zero = (lambda: torch.zeros((), dtype=torch.float32, device=dev)) if mesh is None else (lambda: mesh_zeros(mesh))
        g32 = None
        loss, aux = zero(), zero()
        metrics = {k: zero() for k in ("ce", "z_loss", "accuracy")}
        for i in range(A):
            l, m, a, g = one(params, {k: split(k, v, i) for k, v in batch.items()})
            if g32 is None:
                g32 = [torch.zeros_like(gi, dtype=torch.float32) for gi in g]
            for acc, gi in zip(g32, g):
                acc.add_(gi)
            loss, aux = loss + l, aux + a
            metrics = {k: metrics[k] + m[k] for k in metrics}
        inv = 1.0 / A
        return loss * inv, {k: v * inv for k, v in metrics.items()}, aux * inv, [g.mul_(inv) for g in g32]

    return grads


def make_train_step(cfg: ModelConfig, run: RunConfig, model_api, rules: AxisRules = NO_SHARD, grad_specs=None):
    """``train_step(state, batch) → (state, metrics)``.  The state is
    updated in place and returned; the metrics are 0-d tensors: ``loss``,
    ``aux``, ``lr``, ``ce``, ``z_loss``, ``accuracy``, ``grad_norm``,
    ``clip_scale``.  ``grad_specs``: an optional ``Spec`` tree the
    gradients are redistributed to right after the backward pass, over a
    mesh (the reference's 'gradrs' lever)."""
    opt_cfg = AdamWConfig(weight_decay=run.weight_decay, grad_clip=run.grad_clip)
    grad_fn = make_grad_fn(cfg, run, model_api, rules, grad_specs)

    def train_step(state, batch):
        step = local(state["step"])
        with tracing.span("train.step"):
            loss, metrics, aux, grads = grad_fn(state["params"], batch)
            with tracing.span("train.optimizer", device=step.device):
                grads = tree_unflatten(state["params"], grads)
                if run.grad_compression == "int8":
                    grads, state["error_fb"] = compress_grads(grads, state["error_fb"])
                lr = cosine_warmup(step, peak_lr=run.learning_rate, warmup=run.warmup_steps, total=run.total_steps)
                if run.master_weights:
                    opt_metrics = adamw_update(state["opt"]["master"], grads, state["opt"], lr, opt_cfg)
                    with torch.no_grad():
                        for p, m in zip(tree_leaves(state["params"]), tree_leaves(state["opt"]["master"])):
                            local(p).copy_(local(m))
                else:
                    opt_metrics = adamw_update(state["params"], grads, state["opt"], lr, opt_cfg)
                step += 1
        return state, {"loss": loss, "aux": aux, "lr": lr, **metrics, **opt_metrics}

    return train_step


def _constrain(grads, specs, mesh):
    """``grads`` redistributed by the ``Spec`` tree ``specs``, key by key;
    a ``None`` spec leaves its subtree as it is (the reference's
    ``with_sharding_constraint`` tree map)."""
    if specs is None:
        return grads
    if isinstance(specs, Spec):
        return relaid(grads, placements(specs, mesh), mesh)
    if isinstance(specs, dict):
        return {k: _constrain(grads[k], s, mesh) for k, s in specs.items()}
    return type(specs)(_constrain(g, s, mesh) for g, s in zip(grads, specs))


def jit_train_step(train_step, mesh=None, state_specs=None, batch_specs=None):
    """The reference's ``jit`` of the step.  Without a mesh the port's step
    already runs eagerly in place, so it is returned as it is.  Over a
    ``DeviceMesh`` (every rank calls the step): the state and the batch,
    plain tensors or DTensors, are laid out by ``state_specs`` and
    ``batch_specs`` (the reference's ``in_shardings``), the step runs with
    the mesh ambient, and it returns the state in ``state_specs`` (the
    ``out_shardings``) and the metrics as plain tensors, the same on every
    rank."""
    if mesh is None:
        return train_step

    def sharded_step(state, batch):
        with set_mesh(mesh):
            state = lay_out(state, state_specs, mesh)
            batch = lay_out(batch, batch_specs, mesh)
            state, metrics = train_step(state, batch)
            state = lay_out(state, state_specs, mesh)
        return state, {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}

    return sharded_step
