"""The configuration contract's share cut (``test_cardbench_layout.py``
``contract_errors``) against throwaway configurations: a chip's share of
a stated deployment's experts and vocabulary passes; arithmetic that does
not add up, a share of a width or of the heads, a width in ``reduced``
and a key given two reasons are refused."""

from __future__ import annotations

import copy

import pytest
from test_cardbench_layout import SHARE_KEYS, contract_errors, published_errors, width_errors

# DeepSeek-V3's published config.json (the model-configs catalog's entry)
PUBLISHED_V3 = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 3, "hidden_act": "silu", "hidden_size": 7168,
    "intermediate_size": 18432, "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v3", "moe_intermediate_size": 2048, "moe_layer_freq": 1, "n_group": 8,
    "n_routed_experts": 256, "n_shared_experts": 1, "norm_topk_prob": True, "num_attention_heads": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 61, "num_key_value_heads": 128, "num_nextn_predict_layers": 1,
    "q_lora_rank": 1536, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1, "mscale_all_dim": 1,
                     "original_max_position_embeddings": 4096, "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 2.5, "scoring_func": "sigmoid", "tie_word_embeddings": False,
    "topk_group": 4, "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 129280,
}

# one EP32 rank of DeepSeek-V3: 1 dense and 4 MoE layers, 8 of 256 experts,
# an eighth of the vocabulary
V3_RANK = dict(
    copy.deepcopy(PUBLISHED_V3),
    num_hidden_layers=5, first_k_dense_replace=1, n_routed_experts=8, vocab_size=16160,
    reduced_why={"num_hidden_layers": "61 -> 5: one dense and four MoE layers; the rest lie on further ranks",
                 "first_k_dense_replace": "3 -> 1: leading dense layers count once"},
    shares={"n_routed_experts": {"published": 256, "chips": 32, "held": 8,
                                 "how": "expert parallelism over 32 ranks, 8 whole experts each; the router over all 256"},
            "vocab_size": {"published": 129280, "chips": 8, "held": 16160,
                           "how": "the embedding and the output head split by rows over 8 ranks"}},
)
V3_ENTRY = {"name": "deepseek-v3-671b-5l-ep32", "source": "https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json",
            "file": "cardbench/configs/deepseek-v3-671b-5l-ep32.json",
            "reduced": ["num_hidden_layers", "first_k_dense_replace", "n_routed_experts", "vocab_size"],
            "why": "throwaway"}


def _cut(**changes):
    """``V3_ENTRY`` and ``V3_RANK`` with ``changes`` (``reduced`` goes to the entry)."""
    entry, body = copy.deepcopy(V3_ENTRY), copy.deepcopy(V3_RANK)
    if "reduced" in changes:
        entry["reduced"] = changes.pop("reduced")
    body.update(changes)
    return entry, body


def test_v3_share_cut_passes():
    assert contract_errors(V3_ENTRY, V3_RANK) == []
    assert published_errors(V3_ENTRY, V3_RANK, PUBLISHED_V3) == []


@pytest.mark.parametrize("key, chips", [("n_routed_experts", 31), ("vocab_size", 9)])
def test_share_that_does_not_add_up(key, chips):
    entry, body = _cut()
    body["shares"][key]["chips"] = chips
    assert any("chips !=" in e for e in contract_errors(entry, body))


@pytest.mark.parametrize("field", ["published", "chips", "held", "how"])
def test_share_needs_its_four_fields(field):
    entry, body = _cut()
    del body["shares"]["n_routed_experts"][field]
    assert "shares.n_routed_experts needs exactly published, chips, held and how" in contract_errors(entry, body)


def test_share_must_say_how_the_chips_split():
    entry, body = _cut()
    body["shares"]["vocab_size"]["how"] = ""
    assert "shares.vocab_size needs exactly published, chips, held and how" in contract_errors(entry, body)


def test_file_must_hold_what_the_share_states():
    entry, body = _cut(n_routed_experts=16)
    assert any("not the 8 held" in e for e in contract_errors(entry, body))


def test_share_must_be_in_reduced():
    entry, body = _cut(reduced=["num_hidden_layers", "first_k_dense_replace", "vocab_size"])
    assert any("shares.n_routed_experts is not in reduced" in e for e in contract_errors(entry, body))


@pytest.mark.parametrize("key, held, published", [
    ("num_experts_per_tok", 1, 8), ("hidden_size", 896, 7168),
    ("num_attention_heads", 16, 128), ("num_key_value_heads", 16, 128),
])
def test_share_of_a_width_is_refused(key, held, published):
    entry, body = _cut(**{key: held}, reduced=V3_ENTRY["reduced"] + [key])
    body["shares"][key] = {"published": published, "chips": published // held, "held": held,
                           "how": f"split over {published // held} ranks"}
    errors = contract_errors(entry, body)
    assert f"shares.{key}: a chip holds a share of {SHARE_KEYS} only" in errors
    assert f"{key} is a width" in errors


@pytest.mark.parametrize("key", [
    "hidden_size", "intermediate_size", "moe_intermediate_size", "kv_lora_rank", "q_lora_rank",
    "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "num_attention_heads", "num_key_value_heads",
    "num_experts_per_tok",
])
def test_width_in_reduced_is_still_refused(key):
    entry, body = _cut(**{key: PUBLISHED_V3[key] // 2}, reduced=V3_ENTRY["reduced"] + [key])
    body["reduced_why"][key] = "halved"
    assert width_errors(entry, body) == [f"{key} is a width"]
    assert contract_errors(entry, body) == [f"{key} is a width"]


def test_key_under_shares_and_reduced_why_is_refused():
    entry, body = _cut()
    body["reduced_why"]["vocab_size"] = "an eighth of the rows"
    assert "vocab_size is under both reduced_why and shares" in contract_errors(entry, body)


def test_share_names_its_published_count():
    entry, body = _cut()
    body["shares"]["vocab_size"].update(published=64640, chips=4)
    assert contract_errors(entry, body) == []
    assert published_errors(entry, body, PUBLISHED_V3) == ["shares.vocab_size states 64640 published, the source 129280"]
