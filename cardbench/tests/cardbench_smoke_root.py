"""A checkout of the benchmark at smoke sizes, for the CPU tests.

``smoke_root(tmp)`` copies ``cardbench/`` into ``tmp``, links the port's
``src/`` beside it, and rewrites every configuration and traffic file at
a size a test can hold: the same keys and the same code, smaller
numbers.  The limits are the smoke sizes' own (the cells' limits were set
at the cells' sizes), with ``rule_gap`` only where the cell's reference
moves weights by a rule.  ``run_cell`` runs one cell there on the CPU,
skipping the harness's look for a card.
"""

from __future__ import annotations

import copy
import json
import math
import shutil
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]

SMALL_MODEL = {
    "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32, "vocab_size": 512,
    "intermediate_size": 96,
}
SMALL_Q_LORA_RANK = 24  # where the file has a low-rank query
SMALL_SHARE_CHIPS = 4  # a share is held over this many chips: 8 of 32 experts, 512 of 2,048 rows
SMALL_TRAFFIC = {"sort": {"keys": 70_000, "pool": 2, "check_every": 4, "trace_calls": 2},
                 "train": {"seq_len": 32, "trace_calls": 2}}
# set from the smoke sizes' readings (``drivers/train.py`` ``readings`` on the CPU,
# seeds 1-3): sound loss / grad / change gaps at most 1.5e-3 / 1.4e-2 /
# 4.4e-3, the fp8 control's at least 3.8e-3 / 7.3e-2 / 9.4e-3, half the
# batch 7.3e-3 / 0.50 / 0.15, the state left unchanged 1.0 in change
SMOKE_LIMITS = {
    "sort": {"mismatched_keys": {"limit": 0}},
    "train": {"loss_gap": {"limit": 5e-3}, "grad_gap": {"limit": 4e-2}, "change_gap": {"limit": 0.5}},
}
# where the cell's reference moves weights by a rule; set from the 2 x 4,096
# cell's readings with a reference that names the final norm's scale a rule
# leaf (``test_cardbench_train_driver.py``, seeds 1-3): sound 0.029-0.065,
# half the batch 0.45-0.56, the state left unchanged 1.0
RULE_GAP_LIMIT = {"rule_gap": {"limit": 0.3}}


def small_model(body: dict) -> dict:
    """A model configuration at the smoke sizes: ``SMALL_MODEL``'s numbers,
    a low-rank query's rank where the file has one, and each share of the
    file held at its small count over ``SMALL_SHARE_CHIPS`` chips, with
    the expert groups dividing the routed experts."""
    body = dict(copy.deepcopy(body), **SMALL_MODEL)
    if body.get("q_lora_rank"):
        body["q_lora_rank"] = SMALL_Q_LORA_RANK
    for key, share in body.get("shares", {}).items():
        share.update(held=body[key], chips=SMALL_SHARE_CHIPS, published=body[key] * SMALL_SHARE_CHIPS)
    experts = body.get("shares", {}).get("n_routed_experts", {}).get("published", body["n_routed_experts"])
    if "n_group" in body:
        body["n_group"] = math.gcd(body["n_group"], experts)
        body["topk_group"] = min(body["topk_group"], body["n_group"])
    return body


def has_rule_leaves(root: Path, body: dict) -> bool:
    """Whether the configuration's reference moves weights by a rule."""
    from cardbench import run

    ref = run.load(root / "cardbench" / "reference" / f"{body['family']}.py", "reference")
    return bool(getattr(ref, "rule_leaves", lambda c: [])(body))


def smoke_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "cardbench", root / "cardbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(REPO / "src")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bodies = {}
    for c in bench["configs"]:
        path = root / c["file"]
        body = json.loads(path.read_text())
        if body["family"] != "ohhc_sort":
            body = small_model(body)
        path.write_text(json.dumps(body))
        bodies[c["name"]] = body
    for w in bench["workloads"]:
        path = root / "cardbench" / "traffic" / f"{w['traffic']}.json"
        traffic = json.loads(path.read_text())
        traffic.update(SMALL_TRAFFIC[traffic["kind"]])
        path.write_text(json.dumps(traffic))
        limits = dict(SMOKE_LIMITS[traffic["kind"]])
        if traffic["kind"] == "train" and has_rule_leaves(root, bodies[w["config"]]):
            limits.update(RULE_GAP_LIMIT)
        (root / "cardbench" / "limits" / f"{w['name']}.json").write_text(json.dumps(limits))
    return root


def run_cell(root: Path, workload: str, *, seconds: float = 0.5, trace: bool = False, seed: int = 3_000_000_017):
    """One run of ``workload`` under ``root`` on the CPU: the result line."""
    from cardbench import run

    return run.run(run.cell(root, workload), seed, seconds, trace, torch.device("cpu"), t_start=time.perf_counter())


def workloads() -> list[str]:
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
