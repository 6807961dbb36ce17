"""Every entry of ``BENCHMARK.json`` resolves to its files by name, the file
keeps to the benchmark's contract, and nothing under ``cardbench/``
imports JAX or the JAX package (the references nothing of the port)."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden_size", "intermediate_size", "moe_intermediate_size", "kv_lora_rank", "q_lora_rank",
          "num_attention_heads", "num_key_value_heads", "num_experts_per_tok")
PUBLISHED_V2_LITE = {
    "attention_bias": False,
    "first_k_dense_replace": 1,
    "hidden_act": "silu",
    "hidden_size": 2048,
    "intermediate_size": 10944,
    "kv_lora_rank": 512,
    "max_position_embeddings": 163840,
    "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408,
    "moe_layer_freq": 1,
    "n_group": 1,
    "n_routed_experts": 64,
    "n_shared_experts": 2,
    "norm_topk_prob": False,
    "num_attention_heads": 16,
    "num_experts_per_tok": 6,
    "num_hidden_layers": 27,
    "num_key_value_heads": 16,
    "q_lora_rank": None,
    "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096, "type": "yarn"},
    "rope_theta": 10000,
    "routed_scaling_factor": 1,
    "scoring_func": "softmax",
    "seq_aux": True,
    "tie_word_embeddings": False,
    "topk_group": 1,
    "topk_method": "greedy",
    "v_head_dim": 128,
    "vocab_size": 102400,
}


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["cardbench"]
    assert len(BENCH["command"]) <= 32 and all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_configs_resolve():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("cardbench/")
        body = json.loads(f.read_text())
        assert (ROOT / "cardbench" / "reference" / f"{body['family']}.py").is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


# DeepSeek-V2-Lite's published config.json (the configuration's source),
# without the keys that say nothing about its shape
PUBLISHED = {
    "https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json": PUBLISHED_V2_LITE,
}


def published_errors(entry: dict, body: dict, published: dict) -> list[str]:
    """A published model keeps every number of its config under its key,
    or names the key in ``reduced``; a width keeps its value inside a
    nested group, listed or not."""
    errors = []
    for k, v in published.items():
        if k not in entry["reduced"]:
            if body.get(k) != v:
                errors.append(f"{k} differs from the source and is not in reduced")
        elif body.get(k) == v:
            errors.append(f"{k} is listed in reduced but unchanged")
        if isinstance(v, dict):
            errors += [f"{k}.{sub}" for sub, x in v.items() if _is_width(sub) and (body.get(k) or {}).get(sub) != x]
    share = body.get("shares", {})
    errors += [f"shares.{k} states {s.get('published')} published, the source {published[k]}"
               for k, s in share.items() if k in published and s.get("published") != published[k]]
    return errors


def test_published_keys_kept_or_reduced():
    seen = 0
    for c in BENCH["configs"]:
        published = PUBLISHED.get(c["source"])
        if published is None:
            continue
        seen += 1
        assert not published_errors(c, json.loads((ROOT / c["file"]).read_text()), published), c["name"]
    assert seen == 1


def _is_width(key: str) -> bool:
    return key in WIDTHS or key.endswith(("_dim", "_rank", "_size"))


# what a chip may hold a share of: routed experts and rows of the vocabulary
SHARE_KEYS = ("n_routed_experts", "vocab_size")


def width_errors(entry: dict, body: dict) -> list[str]:
    """The widths that ``reduced`` cuts.  A key of ``WIDTHS`` or one that
    ends in ``_dim``, ``_rank`` or ``_size`` is a width; the one exception
    is a key of ``SHARE_KEYS`` that the file states as a share."""
    shares = body.get("shares", {})
    return [f"{k} is a width" for k in entry["reduced"] if _is_width(k) and not (k in shares and k in SHARE_KEYS)]


def contract_errors(entry: dict, body: dict) -> list[str]:
    """Where a configuration's ``reduced`` breaks the contract.

    No width is cut (``width_errors``), but a chip may hold a share of a
    stated deployment: the file's ``shares`` group may hold
    ``n_routed_experts`` and ``vocab_size``, and no other key, each as
    ``{"published": N, "chips": c, "held": h, "how": "<what the c chips
    split and how>"}``.  The file's value of the key is then ``held``,
    ``held * chips == published`` exactly, and the key is in ``reduced``
    and under neither ``reduced_why`` nor ``departures``.  Every key of
    ``reduced`` has its reason in the file: ``reduced == cuts | departures
    | shares``, the three disjoint (``reduced_why`` holds the cuts of
    scale, ``departures`` where the port's model departs from the
    published one, ``shares`` the shares)."""
    errors = []
    shares = body.get("shares", {})
    for k, s in shares.items():
        if k not in SHARE_KEYS:
            errors.append(f"shares.{k}: a chip holds a share of {SHARE_KEYS} only")
            continue
        if set(s) != {"published", "chips", "held", "how"} or not (isinstance(s["how"], str) and s["how"]):
            errors.append(f"shares.{k} needs exactly published, chips, held and how")
            continue
        if body.get(k) != s["held"]:
            errors.append(f"{k} is {body.get(k)}, not the {s['held']} held")
        if s["held"] * s["chips"] != s["published"]:
            errors.append(f"shares.{k}: {s['held']} held x {s['chips']} chips != {s['published']} published")
        if k not in entry["reduced"]:
            errors.append(f"shares.{k} is not in reduced")
    errors += width_errors(entry, body)
    cuts, departs = set(body.get("reduced_why", {})), set(body.get("departures", {})) - {"why"}
    share_keys = set(shares)
    for a, b, name in ((cuts, departs, "reduced_why and departures"), (cuts, share_keys, "reduced_why and shares"),
                       (departs, share_keys, "departures and shares")):
        errors += [f"{k} is under both {name}" for k in sorted(a & b)]
    if set(entry["reduced"]) != cuts | departs | share_keys:
        errors.append(f"reduced {sorted(entry['reduced'])} is not reduced_why | departures | shares")
    return errors


def test_reduced_names_no_width():
    """No width in ``reduced`` but a share (``width_errors``)."""
    for c in BENCH["configs"]:
        assert not width_errors(c, json.loads((ROOT / c["file"]).read_text())), c["name"]


def test_every_changed_key_has_its_reason():
    """Every key of ``reduced`` is a cut, a departure or a share, and
    every share is the deployment's arithmetic (``contract_errors``)."""
    for c in BENCH["configs"]:
        assert not contract_errors(c, json.loads((ROOT / c["file"]).read_text())), c["name"]


def test_workloads_resolve():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((ROOT / "cardbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "cardbench" / "drivers" / f"{traffic['kind']}.py").is_file()
        limits = json.loads((ROOT / "cardbench" / "limits" / f"{w['name']}.json").read_text())
        assert limits and all("limit" in v for v in limits.values())
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_resolve():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "cardbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        mine = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


SOURCES = sorted((ROOT / "cardbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((ROOT / "cardbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert not _imports(path) & {"repro_torch", "cardbench", "jax", "jaxlib", "flax", "repro"}


def test_import_check_compares_whole_names(tmp_path):
    """``repro_torch`` begins with ``repro`` and must not be taken for it."""
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.kernels\nfrom repro_torch import core\nimport jax.numpy\n")
    assert _imports(probe) == {"repro_torch", "jax"}
    assert _imports(probe) & {"jax", "jaxlib", "flax", "repro"} == {"jax"}
