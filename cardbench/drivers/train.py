"""The training job: the port's training step, one new batch a step.

Set-up builds one state (the weights from the seed, AdamW's moments, the
step) and the port's ``make_train_step`` under a ``RunConfig`` from the
configuration, drives it through its first ``check_steps`` steps and
keeps the readings the check compares: each step's loss, the first
gradient as the optimizer got it (from ``m`` after step 1, unclipped by
the step's own ``grad_norm``) and each weight's change after the last of
them.  The window goes on with that same state.  A step ends in the
``.item()`` of its metrics, as ``Trainer.run_steps`` reads them.

The reference (``reference/<family>.py``) gives ``weight_specs(config)``
and ``train(make_weight, batches, config, precision)``.  Where its step
moves some weights by a rule and not by a gradient (DeepSeek-V3's expert
bias, updated by the sign of each expert's load), it also gives
``rule_leaves(config)``, their names; its ``train`` then returns their
change tensors under ``rule``, the driver keeps the program's whole, and
the check compares them as ``rule_gap``.  A leaf that starts at zero, as
that bias does, is a spec of std ``0.0``, which ``generate.weight``
draws as zeros.
"""

from __future__ import annotations

import dataclasses
import inspect
import statistics
import time

import torch

from cardbench import generate


PORT_FIELDS = {
    "q_lora_rank": ("mla", "q_lora_rank", "null", lambda v: v is None),
    "rope_scaling": ("", "rope_scaling", "none, or YaRN at factor 1",
                     lambda v: not v or (v.get("type") == "yarn" and v.get("factor") == 1)),
    "first_k_dense_replace": ("", "first_k_dense_replace", "0", lambda v: v == 0),
    "num_nextn_predict_layers": ("", "num_nextn_predict_layers", "0", lambda v: v == 0),
    "scoring_func": ("moe", "scoring_func", "softmax", lambda v: v == "softmax"),
    "topk_method": ("moe", "topk_method", "greedy", lambda v: v == "greedy"),
    "n_group": ("moe", "n_group", "1", lambda v: v == 1),
    "topk_group": ("moe", "topk_group", "1", lambda v: v == 1),
    "routed_scaling_factor": ("moe", "routed_scaling_factor", "1", lambda v: v == 1),
    "norm_topk_prob": ("moe", "norm_topk_prob", "true", lambda v: v is True),
    "seq_aux": ("moe", "seq_aux", "false", lambda v: v is False),
    "assumed.dropless": ("moe", "dropless", "false", lambda v: v is False),
    "assumed.bias_update_speed": ("moe", "bias_update_speed", "0", lambda v: v == 0),
}
"""The published keys that the port names its fields after, each as
``file key: (group of the port's config, field, what the port runs
without the field, as text and as a test of the file's value)``.

A key of the configuration file (``assumed.<key>`` for a training
setting under ``assumed``) reaches the port under the field of the same
name where the port's config (or its ``mla`` or ``moe`` group) has one.
Where it has none, the file has to state what the port runs without it,
or the run stops.  A later port that adds the field needs no change
here.  Besides: ``first_k_dense_replace`` above 0 also gives
``intermediate_size`` to ``d_ff``, and ``shares.n_routed_experts`` gives
``moe.num_experts`` the published count and ``moe.experts_held`` the
count held, this chip holding experts ``0 ... held - 1``."""

# what the port runs where it has no setting (``models/layers.py``)
PORT_RUNS = {"hidden_act": "silu", "attention_bias": False, "moe_layer_freq": 1, "rms_norm_eps": 1e-6}
# read by nothing a step computes
INERT = ("model_type", "max_position_embeddings", "ep_size")
# read by ``model_config`` below or by ``Cell``
READ = ("num_hidden_layers", "hidden_size", "num_attention_heads", "num_key_value_heads", "vocab_size",
        "rope_theta", "tie_word_embeddings", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "n_routed_experts", "num_experts_per_tok", "n_shared_experts", "moe_intermediate_size", "intermediate_size",
        "capacity_factor", "router_aux_loss", "z_loss", "optimizer")
# the benchmark's own: no model key
BENCHMARK_KEYS = ("name", "source", "paper", "family", "port_arch", "deployment", "reduced_why", "departures",
                  "shares", "assumed")
# the settings under ``assumed`` that ``model_config`` reads
ASSUMED = ("dtype", "param_dtype", "attention_dtype", "remat", "dispatch", "why")


def model_config(config: dict):
    """The port's ``ModelConfig`` for the configuration file: its entry in
    the port's registry with every size and setting the file states.  A
    model key that cannot reach the port stops the run with a
    ``ValueError`` that names it, before any weight is drawn."""
    from repro_torch.configs import registry

    a = config["assumed"]
    known = set(PORT_FIELDS) | set(PORT_RUNS) | set(INERT) | set(READ) | set(BENCHMARK_KEYS)
    unknown = [k for k in config if k not in known]
    unknown += [f"assumed.{k}" for k in a if k not in ASSUMED and f"assumed.{k}" not in PORT_FIELDS]
    if unknown:
        raise ValueError(f"the benchmark passes no {unknown} to the port")
    for key, runs in PORT_RUNS.items():
        if key in config and config[key] != runs:
            raise ValueError(f"{key} is {config[key]!r}; the port runs {runs!r}")
    base = registry.get_config(config["port_arch"])
    top = dict(
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
    )
    mla = dict(
        kv_lora_rank=config["kv_lora_rank"],
        qk_nope_head_dim=config["qk_nope_head_dim"],
        qk_rope_head_dim=config["qk_rope_head_dim"],
        v_head_dim=config["v_head_dim"],
    )
    moe = dict(
        num_experts=config["n_routed_experts"],
        num_experts_per_tok=config["num_experts_per_tok"],
        num_shared_experts=config["n_shared_experts"],
        expert_d_ff=config["moe_intermediate_size"],
        shared_d_ff=config["moe_intermediate_size"],
        router_aux_loss=config["router_aux_loss"],
        dispatch=a["dispatch"],
        capacity_factor=config["capacity_factor"],
    )
    groups = {"": (base, top), "mla": (base.mla, mla), "moe": (base.moe, moe)}
    for key, (group, field, without, runs_without) in PORT_FIELDS.items():
        where, name = (a, key[len("assumed."):]) if key.startswith("assumed.") else (config, key)
        if name not in where:
            continue
        port, passed = groups[group]
        if field in {f.name for f in dataclasses.fields(port)}:
            passed[field] = where[name]
        elif not runs_without(where[name]):
            raise ValueError(f"{key} is {where[name]!r}; the port's {type(port).__name__} has no {field} "
                             f"and runs {without}")
    if top.get("first_k_dense_replace"):
        top["d_ff"] = config["intermediate_size"]
    for key, share in config.get("shares", {}).items():
        if key == "vocab_size":  # the file's vocab_size is the rows held, the vocabulary the port runs
            continue
        if key != "n_routed_experts":
            raise ValueError(f"shares.{key}: the port holds a share of n_routed_experts only")
        if "experts_held" not in {f.name for f in dataclasses.fields(base.moe)}:
            raise ValueError(f"shares.{key}: the port's {type(base.moe).__name__} has no experts_held")
        moe.update(num_experts=share["published"], experts_held=share["held"])
    return dataclasses.replace(base, **top, mla=dataclasses.replace(base.mla, **mla),
                               moe=dataclasses.replace(base.moe, **moe))


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
        self.rule = set(getattr(reference, "rule_leaves", lambda c: [])(config))
        if self.rule - set(self.names):
            raise ValueError(f"rule leaves {sorted(self.rule - set(self.names))} are no weights of the port")
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
        change, rule = {}, {}
        with torch.no_grad():  # from the weights as the program holds them at step 0
            for k, p in zip(self.names, tree_leaves(self.state["params"])):
                delta = p.to(torch.float32) - self.make_weight(k).to(p.dtype).float()
                change[k] = float(torch.linalg.vector_norm(delta))
                if k in self.rule:
                    rule[k] = delta.cpu()
        self.readings["change"] = change
        if rule:
            self.readings["rule"] = rule
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
    """The check's numbers; a run compares those that have a limit in
    ``limits/<workload>.json`` and prints the others.  Weights whose first
    gradient in the reference is under a thousandth of the median weight's
    move by round-off alone and are left out of the change.  Where the
    reference moves weights by a rule (``rule``), ``rule_gap`` is the
    worst such weight's ``|dp - dr| / |dr|``: the norm of the difference
    between the program's change tensor and the reference's, over the
    norm of the reference's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    med = statistics.median(want["grad"].values())
    moved = [n for n, g in want["grad"].items() if g >= 1e-3 * med]
    out = {
        "loss_gap": loss,
        "grad_gap": gap(got["grad"], want["grad"], want["grad"]),
        "change_gap": gap(got["change"], want["change"], moved),
    }
    if want.get("rule"):
        out["rule_gap"] = max(
            float(torch.linalg.vector_norm(got["rule"][n] - d) / torch.linalg.vector_norm(d).clamp(min=1e-30))
            for n, d in want["rule"].items())
    return out


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
        if "rule" in got:
            still["rule"] = {k: torch.zeros_like(d) for k, d in got["rule"].items()}
        out["fault.state_unchanged"] = compare(still, want)
        _, bad, _ = program(c["config"], "half_batch")
        out["fault.half_batch"] = compare(bad, want)
        out["fault.half_batch_leaves"] = leaves(bad, want)
    return out
