"""A checkout of the benchmark at smoke sizes, for the CPU tests.

``smoke_root(tmp)`` copies ``cardbench/`` into ``tmp``, links the port's
``src/`` beside it, and rewrites every configuration and traffic file at
a size a test can hold: the same keys and the same code, smaller
numbers.  The limits are the smoke sizes' own (the cells' limits were set
at the cells' sizes).  ``run_cell`` runs one cell there on the CPU,
skipping the harness's look for a card.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]

SMALL_MODEL = {
    "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32, "vocab_size": 512,
}
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


def smoke_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "cardbench", root / "cardbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(REPO / "src")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = root / c["file"]
        body = json.loads(path.read_text())
        if body["family"] != "ohhc_sort":
            body.update(SMALL_MODEL)
        path.write_text(json.dumps(body))
    for w in bench["workloads"]:
        path = root / "cardbench" / "traffic" / f"{w['traffic']}.json"
        traffic = json.loads(path.read_text())
        traffic.update(SMALL_TRAFFIC[traffic["kind"]])
        path.write_text(json.dumps(traffic))
        (root / "cardbench" / "limits" / f"{w['name']}.json").write_text(json.dumps(SMOKE_LIMITS[traffic["kind"]]))
    return root


def run_cell(root: Path, workload: str, *, seconds: float = 0.5, trace: bool = False, seed: int = 3_000_000_017):
    """One run of ``workload`` under ``root`` on the CPU: the result line."""
    from cardbench import run

    return run.run(run.cell(root, workload), seed, seconds, trace, torch.device("cpu"), t_start=time.perf_counter())


def workloads() -> list[str]:
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
