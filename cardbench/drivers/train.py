"""The training job: the port's training step, one new batch a step.

Set-up builds one state (the weights from the seed, AdamW's moments, the
step) and the port's ``make_train_step`` under a ``RunConfig`` from the
configuration, drives it through its first ``check_steps`` steps and
keeps the readings the check compares: each step's loss, the first
gradient as the optimizer got it (from ``m`` after step 1, unclipped by
the step's own ``grad_norm``) and each weight's change after the last of
them.  The window goes on with that same state.  A step ends in the
``.item()`` of its metrics, as ``Trainer.run_steps`` reads them.
"""

from __future__ import annotations

import inspect
import statistics
import time

import torch

from cardbench import generate


def model_config(config: dict):
    """The port's ``ModelConfig`` for the configuration file: its entry in
    the port's registry with every size and setting the file states."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import MLAConfig, MoEConfig

    a = config["assumed"]
    if (config.get("rope_scaling") or {}).get("factor", 1) > 1:
        raise ValueError("the port has plain RoPE: YaRN only at factor 1, where it is the identity")
    base = registry.get_config(config["port_arch"])
    cfg = base.replace(
        num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        vocab_size=config["vocab_size"],
        rope_theta=float(config["rope_theta"]),
        tie_embeddings=config["tie_word_embeddings"],
        dtype=getattr(torch, a["dtype"]),
        param_dtype=getattr(torch, a["param_dtype"]),
        remat=a["remat"],
        attn_matmul_bf16=a["attention_dtype"] != "float32",
        mla=MLAConfig(
            kv_lora_rank=config["kv_lora_rank"],
            qk_nope_head_dim=config["qk_nope_head_dim"],
            qk_rope_head_dim=config["qk_rope_head_dim"],
            v_head_dim=config["v_head_dim"],
        ),
        moe=MoEConfig(
            num_experts=config["n_routed_experts"],
            num_experts_per_tok=config["num_experts_per_tok"],
            num_shared_experts=config["n_shared_experts"],
            expert_d_ff=config["moe_intermediate_size"],
            shared_d_ff=config["moe_intermediate_size"],
            router_aux_loss=config["router_aux_loss"],
            dispatch=a["dispatch"],
            capacity_factor=config["capacity_factor"],
            expert_parallel=base.moe.expert_parallel,
        ),
    )
    return cfg


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Dotted names of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}.")]
    return [prefix[:-1]]


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, reference):
        from repro_torch.configs.base import RunConfig, ShapeConfig
        from repro_torch.configs.registry import get_model_api
        from repro_torch.models.common import shapes_only, tree_leaves, tree_unflatten
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.train.loss import lm_loss
        from repro_torch.train.train_step import make_train_step

        self.config, self.traffic, self.seed, self.device, self.ref = config, traffic, seed, device, reference
        o = config["optimizer"]
        want = AdamWConfig(b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"], grad_clip=o["grad_clip"])
        got = AdamWConfig(weight_decay=o["weight_decay"], grad_clip=o["grad_clip"])
        if got != want:
            raise ValueError(f"the port's AdamW runs {got}, the configuration states {want}")
        z_loss = inspect.signature(lm_loss).parameters["z_loss"].default
        if z_loss != config["z_loss"]:
            raise ValueError(f"the port's z-loss weight is {z_loss}, the configuration states {config['z_loss']}")
        self.b1 = o["b1"]
        cfg = model_config(config)
        B, S = traffic["batch"], traffic["seq_len"]
        run = RunConfig(model=cfg, shape=ShapeConfig(f"{B}x{S}", S, B, "train"), learning_rate=o["learning_rate"],
                        weight_decay=o["weight_decay"], warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                        grad_clip=o["grad_clip"], checkpoint_every=0)
        api = get_model_api(cfg)
        with shapes_only():
            shapes = api.init(cfg, torch.Generator(device))
        self.names = leaf_names(shapes)
        self.specs = {s[0]: (i, s) for i, s in enumerate(reference.weight_specs(config))}
        if sorted(self.names) != sorted(self.specs):
            raise ValueError(f"the port's weights {sorted(self.names)} are not the benchmark's {sorted(self.specs)}")
        leaves = []
        for name, shape in zip(self.names, tree_leaves(shapes)):
            w = self.make_weight(name)
            if tuple(w.shape) != tuple(shape.shape):
                raise ValueError(f"{name}: the port's shape {tuple(shape.shape)}, the benchmark's {tuple(w.shape)}")
            leaves.append(w.to(cfg.param_dtype))
        params = tree_unflatten(shapes, leaves)
        self.state = {"params": params, "opt": adamw_init(params),
                      "step": torch.zeros((), dtype=torch.int32, device=device)}
        self.step_fn = make_train_step(cfg, run, api)
        self.readings: dict = {}

    def make_weight(self, name: str) -> torch.Tensor:
        i, spec = self.specs[name]
        return generate.weight(spec, self.seed, i, self.device)

    def batch(self, step: int) -> dict:
        """The batch of step ``step`` (from 1)."""
        return generate.token_batch(self.traffic, self.config["vocab_size"], self.seed, step, self.device)

    def step(self, n: int) -> dict:
        self.state, metrics = self.step_fn(self.state, self.batch(n))
        return {k: v.item() for k, v in metrics.items()}

    def warm(self) -> None:
        from repro_torch.models.common import tree_leaves

        losses = []
        for n in range(1, self.traffic["check_steps"] + 1):
            m = self.step(n)
            losses.append(m["loss"])
            if n == 1:
                # m = (1 - b1) g scale after one step; scale = min(1, clip / |g|)
                scale = min(1.0, self.config["optimizer"]["grad_clip"] / max(m["grad_norm"], 1e-9))
                self.readings["grad"] = {
                    k: float(torch.linalg.vector_norm(x)) / (1 - self.b1) / scale
                    for k, x in zip(self.names, tree_leaves(self.state["opt"]["m"]))
                }
        with torch.no_grad():  # from the weights as the program holds them at step 0
            self.readings["change"] = {
                k: float(torch.linalg.vector_norm(p.to(torch.float32) - self.make_weight(k).to(p.dtype).float()))
                for k, p in zip(self.names, tree_leaves(self.state["params"]))
            }
        self.readings["loss"] = losses

    def call(self, i: int, traced: bool, span) -> int:
        with span("step"):
            self.step(self.traffic["check_steps"] + 1 + i)
        return self.traffic["batch"] * self.traffic["seq_len"]

    def close(self) -> None:
        self.state = self.step_fn = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        batches = [self.batch(n) for n in range(1, self.traffic["check_steps"] + 1)]
        want = self.ref.train(self.make_weight, batches, self.config)
        return compare(self.readings, want)


def gap(got: dict, want: dict, names) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    names = list(names)
    med = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names)


def compare(got: dict, want: dict) -> dict:
    """The check's three numbers; a run compares those that have a limit in
    ``limits/<workload>.json`` and prints the others.  Weights whose first
    gradient in the reference is under a thousandth of the median weight's
    move by round-off alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    med = statistics.median(want["grad"].values())
    moved = [n for n, g in want["grad"].items() if g >= 1e-3 * med]
    return {
        "loss_gap": loss,
        "grad_gap": gap(got["grad"], want["grad"], want["grad"]),
        "change_gap": gap(got["change"], want["change"], moved),
    }


def half(batch: dict) -> dict:
    """Half of a batch: the first half of its rows, or of its positions
    where it has one row."""
    B, S = batch["tokens"].shape
    if B > 1:
        return {k: v[: B // 2] for k, v in batch.items()}
    return {k: v[:, : S // 2] for k, v in batch.items()}


def leaves(got: dict, want: dict) -> dict:
    """Every weight's gradient and change gap, largest first, as
    ``[name, gap, own]``: ``gap`` against the larger of its own and the
    median weight's reference norm (as :func:`gap`), ``own`` against its
    own norm alone."""
    out = {}
    for key in ("grad", "change"):
        med = statistics.median(want[key].values())
        rows = [[k, abs(got[key][k] - want[key][k]) / max(want[key][k], med, 1e-30),
                 abs(got[key][k] - want[key][k]) / max(want[key][k], 1e-30)] for k in want[key]]
        out[key] = sorted(rows, key=lambda r: -r[1])
    return out


def readings(c: dict, seed: int, control: bool, faults: bool, device) -> dict:
    """One seed's readings for ``cardbench.readings``: the cell's own
    set-up steps against the reference's.  The control is the program's
    own lower-precision path, its weights and their updates in bfloat16
    (the configuration states float32); beside it, the reference with
    fp8 matmul operands (the step below bf16 compute).  The faults: the
    state left unchanged and half the batch."""
    from cardbench import run as harness

    ref = harness.load(c["reference"], "reference")
    out = {"seed": seed}

    def program(config: dict, fault=None):
        cell = Cell(config, c["traffic"], seed, device, ref)
        if fault == "half_batch":
            whole = cell.batch
            cell.batch = lambda n: half(whole(n))
        t0 = time.perf_counter()
        cell.warm()
        got = cell.readings
        cell.close()
        return cell, got, time.perf_counter() - t0

    def steps(got: dict) -> list:
        return [abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])]

    cell, got, secs = program(c["config"])
    batches = [cell.batch(n) for n in range(1, c["traffic"]["check_steps"] + 1)]
    t0 = time.perf_counter()
    want = ref.train(cell.make_weight, batches, c["config"])
    out["reference_s"] = time.perf_counter() - t0
    out["program_s"] = secs
    out["sound"] = compare(got, want)
    out["sound_leaves"] = leaves(got, want)
    out["sound_loss_steps"] = steps(got)
    if control:
        low = dict(c["config"], assumed=dict(c["config"]["assumed"], param_dtype="bfloat16"))
        _, ctrl, _ = program(low)
        out["control"] = compare(ctrl, want)
        out["control_leaves"] = leaves(ctrl, want)
        fp8 = ref.train(cell.make_weight, batches, c["config"], "fp8")
        out["fp8_reference"] = compare(fp8, want)
        out["fp8_reference_leaves"] = leaves(fp8, want)
        out["fp8_reference_loss_steps"] = steps(fp8)
    if faults:
        still = dict(got, change={k: 0.0 for k in got["change"]})
        out["fault.state_unchanged"] = compare(still, want)
        _, bad, _ = program(c["config"], "half_batch")
        out["fault.half_batch"] = compare(bad, want)
        out["fault.half_batch_leaves"] = leaves(bad, want)
    return out
