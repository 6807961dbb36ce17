"""The training driver (``drivers/train.py``) on the CPU: ``model_config``
passes every model key of a configuration file to the port or refuses
the file by the key's name, before any weight is drawn; ``rule_gap``
compares weights that the reference moves by a rule."""

from __future__ import annotations

import copy
import dataclasses
import json

import pytest
import torch
from cardbench_smoke_root import REPO, RULE_GAP_LIMIT, run_cell, small_model, smoke_root
from test_cardbench_layout import contract_errors
from test_cardbench_shares import V3_ENTRY, V3_RANK

from cardbench import generate
from cardbench import run as harness

V2_LITE = json.loads((REPO / "cardbench/configs/deepseek-v2-lite-16b-4l.json").read_text())
TRAFFIC = json.loads((REPO / "cardbench/traffic/1x8k.json").read_text())
DRIVER = harness.load(REPO / "cardbench/drivers/train.py", "driver")
REFERENCE = harness.load(REPO / "cardbench/reference/deepseek_v2.py", "reference")
harness.use_program(REPO)


def parent_model_config(config: dict):
    """``model_config`` as it was before the key table, the oracle for the
    configurations it took."""
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


def v3_file(**assumed) -> dict:
    """A DeepSeek-V3-shaped configuration file: one EP32 rank
    (``V3_RANK``) with the V2-Lite file's training settings."""
    own = {k: V2_LITE[k] for k in ("family", "port_arch", "capacity_factor", "router_aux_loss", "z_loss", "optimizer")}
    body = dict(copy.deepcopy(V3_RANK), name=V3_ENTRY["name"], source=V3_ENTRY["source"], **copy.deepcopy(own))
    body["assumed"] = dict(copy.deepcopy(V2_LITE["assumed"]), **assumed)
    return body


V2_FILES = {
    "v2-lite": V2_LITE,
    "v2-lite-smoke": small_model(V2_LITE),
    "v2-lite-bf16-control": dict(V2_LITE, assumed=dict(V2_LITE["assumed"], param_dtype="bfloat16")),
}


@pytest.mark.parametrize("name", list(V2_FILES))
def test_v2_lite_maps_as_before(name):
    assert DRIVER.model_config(V2_FILES[name]) == parent_model_config(V2_FILES[name])


@pytest.fixture
def no_weights(monkeypatch):
    def drawn(*args, **kw):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(generate, "weight", drawn)


def test_v3_refused_by_a_table_key_before_any_weight(no_weights):
    with pytest.raises(ValueError) as err:
        DRIVER.Cell(v3_file(), dict(TRAFFIC, batch=1, seq_len=4096), 5, torch.device("cpu"), REFERENCE)
    assert any(str(err.value).startswith(f"{key} is ") for key in DRIVER.PORT_FIELDS), err.value


# a value of each key of the table other than what today's port runs
NOT_RUN = {
    "q_lora_rank": 1536, "rope_scaling": V3_RANK["rope_scaling"],
    "first_k_dense_replace": 1, "num_nextn_predict_layers": 1, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "n_group": 8, "topk_group": 4, "routed_scaling_factor": 2.5, "norm_topk_prob": False, "seq_aux": True,
    "assumed.dropless": True, "assumed.bias_update_speed": 0.001,
}


def _with(body: dict, key: str, value) -> dict:
    body = copy.deepcopy(body)
    if key.startswith("assumed."):
        body["assumed"][key[len("assumed."):]] = value
    else:
        body[key] = value
    return body


def test_not_run_covers_the_table():
    assert set(NOT_RUN) == set(DRIVER.PORT_FIELDS)


@pytest.mark.parametrize("key", sorted(NOT_RUN))
def test_table_key_the_port_cannot_run_is_refused(key, no_weights):
    with pytest.raises(ValueError, match=f"^{key} is "):
        DRIVER.model_config(_with(V2_LITE, key, NOT_RUN[key]))


@pytest.mark.parametrize("rope", [None, {}, dict(V2_LITE["rope_scaling"], factor=1)], ids=["null", "empty", "yarn-1"])
def test_rope_scaling_the_port_runs(rope):
    assert DRIVER.model_config(dict(V2_LITE, rope_scaling=rope)) == parent_model_config(V2_LITE)


@pytest.mark.parametrize("key, value", [("hidden_act", "gelu"), ("attention_bias", True), ("moe_layer_freq", 2),
                                        ("rms_norm_eps", 1e-5)])
def test_checked_key_is_refused_where_the_port_runs_another(key, value):
    with pytest.raises(ValueError, match=f"^{key} is "):
        DRIVER.model_config(dict(V2_LITE, **{key: value}))


@pytest.mark.parametrize("key", DRIVER.INERT)
def test_inert_key_reaches_nothing(key):
    assert DRIVER.model_config(dict(V2_LITE, **{key: 12345})) == parent_model_config(V2_LITE)


@pytest.mark.parametrize("body", [dict(V2_LITE, sliding_window=4096),
                                  dict(V2_LITE, assumed=dict(V2_LITE["assumed"], loss_scale=1024))],
                         ids=["model", "assumed"])
def test_unknown_key_is_refused(body, no_weights):
    with pytest.raises(ValueError, match="sliding_window|assumed.loss_scale"):
        DRIVER.model_config(body)


def _stand_in():
    """The port's registry entry, with every field of the table on a
    throwaway subclass of its config and groups (None until set)."""
    from repro_torch.configs import registry

    base = registry.get_config(V2_LITE["port_arch"])
    fields = {"": [], "mla": [], "moe": ["experts_held"]}
    for group, field, _, _ in DRIVER.PORT_FIELDS.values():
        fields[group].append(field)

    def sub(obj, names):
        cls = dataclasses.make_dataclass(f"StandIn{type(obj).__name__}", [(n, object, None) for n in names],
                                         bases=(type(obj),), frozen=True)
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})

    top = sub(base, fields[""])
    return dataclasses.replace(top, mla=sub(base.mla, fields["mla"]), moe=sub(base.moe, fields["moe"]))


def test_every_table_field_reaches_a_port_that_has_it(monkeypatch):
    from repro_torch.configs import registry

    stand_in = _stand_in()
    monkeypatch.setattr(registry, "get_config", lambda arch, smoke=False: stand_in)
    body = v3_file(dropless=True, bias_update_speed=0.001)
    body["seq_aux"] = True
    cfg = DRIVER.model_config(body)
    groups = {"": cfg, "mla": cfg.mla, "moe": cfg.moe}
    for key, (group, field, _, _) in DRIVER.PORT_FIELDS.items():
        want = body["assumed"][key[len("assumed."):]] if key.startswith("assumed.") else body[key]
        assert getattr(groups[group], field) == want, key
    assert cfg.d_ff == 18432 and cfg.first_k_dense_replace == 1
    assert cfg.moe.num_experts == 256 and cfg.moe.experts_held == 8
    assert cfg.vocab_size == 16160 and cfg.num_layers == 5 and cfg.mla.q_lora_rank == 1536
    # fields the file does not name keep the registry entry's values
    assert cfg.moe.expert_parallel == stand_in.moe.expert_parallel and cfg.max_seq_len == stand_in.max_seq_len


@pytest.mark.parametrize("key", ["num_attention_heads", "n_routed_experts"])
def test_share_the_port_cannot_hold_is_refused(key):
    body = dict(copy.deepcopy(V2_LITE), shares={key: {"published": 64, "chips": 8, "held": 8, "how": "by rows"}})
    with pytest.raises(ValueError, match=f"^shares.{key}: "):
        DRIVER.model_config(body)


def test_small_v3_keeps_its_share_arithmetic():
    """The smoke size of a V3-shaped file: 8 of 32 experts over 4 chips,
    512 of 2,048 rows, expert groups that divide the 32."""
    small = small_model(v3_file())
    assert contract_errors(V3_ENTRY, small) == []
    assert small["shares"]["n_routed_experts"]["published"] == 32 and small["n_routed_experts"] == 8
    assert 32 % small["n_group"] == 0 and small["topk_group"] <= small["n_group"]
    assert small["q_lora_rank"] == 24 and small["intermediate_size"] == 96


# ------------------------------------------------------------------ rule_gap
RULE_LEAF = "final_norm.scale"


@pytest.fixture
def rule_reference(monkeypatch):
    """Every reference loaded from here on names the final norm's scale
    a rule leaf."""
    load = harness.load

    def patched(path, tag):
        mod = load(path, tag)
        if tag == "reference":
            mod.rule_leaves = lambda c: [RULE_LEAF]
        return mod

    monkeypatch.setattr(harness, "load", patched)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("train_driver"))


def _readings(root, seed, faults):
    c = harness.cell(root, "train.dsv2-lite-4l.2x4k")
    return harness.load(c["driver"], "driver").readings(c, seed, False, faults, torch.device("cpu"))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rule_gap_of_a_rule_leaf(root, rule_reference, seed):
    out = _readings(root, seed, True)
    limit = RULE_GAP_LIMIT["rule_gap"]["limit"]
    assert out["sound"]["rule_gap"] < limit / 3, out["sound"]
    assert out["fault.state_unchanged"]["rule_gap"] == 1.0


def test_no_rule_leaves_no_reading(root):
    out = _readings(root, 1, False)
    assert set(out["sound"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_rule_gap_is_compared_where_the_reference_has_rule_leaves(tmp_path, rule_reference, monkeypatch):
    """The smoke root gives ``rule_gap`` a limit where the reference has
    rule leaves; a sound run passes it, a state left unchanged fails it."""
    rooted = smoke_root(tmp_path)
    workload = "train.dsv2-lite-4l.2x4k"
    assert json.loads((rooted / "cardbench/limits" / f"{workload}.json").read_text())["rule_gap"] == \
        RULE_GAP_LIMIT["rule_gap"]
    res = run_cell(rooted, workload)
    assert res["correct"] and res["checks"]["rule_gap"]["value"] < RULE_GAP_LIMIT["rule_gap"]["limit"]
    from repro_torch.train import train_step

    monkeypatch.setattr(train_step, "adamw_update", lambda params, grads, state, lr, cfg: {
        "grad_norm": lr * 0 + 1.0, "clip_scale": lr * 0 + 1.0})
    res = run_cell(rooted, workload)
    assert not res["correct"] and res["checks"]["rule_gap"]["value"] == 1.0
