"""The benchmark's operation and byte counts against values worked by hand."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
from test_cardbench_shares import V3_RANK

from cardbench import hw, work
from cardbench import run as harness
from cardbench.readers import device_ms

ROOT = Path(__file__).resolve().parents[2]

SMOKE = {
    "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4, "vocab_size": 512,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "q_lora_rank": None,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 2, "moe_intermediate_size": 32,
    "intermediate_size": 96, "first_k_dense_replace": 0,
}


def test_train_step_flops_by_hand():
    # a token a layer: wq 2*64*4*24 + wdkv, wkr 2*64*40 + wuk, wuv 2*32*4*32 + wo 2*4*16*64 = 33,792;
    # router 2*64*8 + 4 experts * 3 * 2*64*32 = 50,176; head 2*64*512 = 65,536
    per_token = 2 * (33_792 + 50_176) + 65_536
    # 2 rows of 32: 528 causal pairs a row, 2*4*(16+8+16) operations a pair a layer
    scores = 2 * (2 * 528) * 320
    assert work.train_step_flops(SMOKE, {"batch": 2, "seq_len": 32}) == 3 * (64 * per_token + scores)


def test_train_step_flops_dense_leading_layer():
    dense = dict(SMOKE, first_k_dense_replace=1)
    extra = 64 * (3 * 2 * 64 * 96 - 50_176)  # layer 0 runs the dense MLP instead of the MoE layer
    assert work.train_step_flops(dense, {"batch": 2, "seq_len": 32}) == work.train_step_flops(
        SMOKE, {"batch": 2, "seq_len": 32}) + 3 * extra


def test_train_step_flops_at_the_cell():
    """DeepSeek-V2-Lite, 4 layers, 2 x 4,096: 28.708 T operations a step."""
    c = json.loads((ROOT / "cardbench/configs/deepseek-v2-lite-16b-4l.json").read_text())
    flops = work.train_step_flops(c, {"batch": 2, "seq_len": 4096})
    assert abs(flops - 28.708e12) < 0.001e12


def test_bytes_by_hand():
    assert work.sort_bytes(15_728_640, "int32") == 125_829_120
    assert work.sort_bytes(1000, "int64") == 16_000
    assert work.count_rank_bytes(49_152, 64) == 4 * (2 * 49_152 + 64)
    assert work.moe_assignments({"num_experts_per_tok": 6}, {"batch": 2, "seq_len": 4096}) == 49_152


def _parent_train_step_flops(config: dict, traffic: dict) -> float:
    """``work.train_step_flops`` as it was before the share cut, kept here
    so that the configurations without one are held to it with ``==``."""
    c = config
    d, H, L, V = c["hidden_size"], c["num_attention_heads"], c["num_hidden_layers"], c["vocab_size"]
    r, dn, dr, dv = c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    B, S = traffic["batch"], traffic["seq_len"]
    q_in = c["q_lora_rank"] or 0
    if q_in:
        attn = 2 * (d * q_in + q_in * H * (dn + dr))
    else:
        attn = 2 * d * H * (dn + dr)
    attn += 2 * (d * (r + dr) + r * H * (dn + dv) + H * dv * d)
    experts = c["num_experts_per_tok"] + c["n_shared_experts"]
    moe = 2 * d * c["n_routed_experts"] + experts * 3 * 2 * d * c["moe_intermediate_size"]
    dense = 3 * 2 * d * c["intermediate_size"]
    k_dense = min(c["first_k_dense_replace"], L)
    per_token = k_dense * (attn + dense) + (L - k_dense) * (attn + moe) + 2 * d * V
    pairs = B * S * (S + 1) // 2
    scores = L * pairs * 2 * H * (dn + dr + dv)
    return 3.0 * (B * S * per_token + scores)


V2_LITE = json.loads((ROOT / "cardbench/configs/deepseek-v2-lite-16b-4l.json").read_text())


@pytest.mark.parametrize("config, traffic", [
    (V2_LITE, "2x4k"), (V2_LITE, "1x8k"), (SMOKE, None), (dict(SMOKE, first_k_dense_replace=1), None),
    (dict(SMOKE, q_lora_rank=24), None),
], ids=["v2-lite-2x4k", "v2-lite-1x8k", "smoke", "smoke-dense", "smoke-q-lora"])
def test_train_step_flops_unchanged_without_a_share(config, traffic):
    t = json.loads((ROOT / f"cardbench/traffic/{traffic}.json").read_text()) if traffic else {"batch": 2, "seq_len": 32}
    assert work.train_step_flops(config, t) == _parent_train_step_flops(config, t)


def test_train_step_flops_of_an_expert_share():
    """One EP32 rank of DeepSeek-V3 (8 of 256 experts, 16,160 of 129,280
    rows, 1 dense and 4 MoE layers) at 1 x 4,096: 5.148e13 operations a
    step, the router 256 wide and 8 * 8 / 256 routed experts a token; read
    as if the 8 held were all, 8.486e13, 1.65 times as many."""
    traffic = {"batch": 1, "seq_len": 4096}
    flops = work.train_step_flops(V3_RANK, traffic)
    assert abs(flops / 5.148e13 - 1) < 1e-3
    whole = {k: v for k, v in V3_RANK.items() if k != "shares"}
    assert abs(work.train_step_flops(whole, traffic) / 8.486e13 - 1) < 1e-3


@pytest.mark.parametrize("config", [V2_LITE, SMOKE], ids=["v2-lite", "smoke"])
def test_a_share_of_every_expert_counts_as_none(config):
    """Held = published on one chip: the same router and experts a token."""
    traffic = {"batch": 2, "seq_len": 64}
    E = config["n_routed_experts"]
    whole = dict(config, shares={"n_routed_experts": {"published": E, "chips": 1, "held": E, "how": "one chip"}})
    assert work.train_step_flops(whole, traffic) == work.train_step_flops(config, traffic)


def test_a_vocabulary_share_counts_the_rows_held():
    """A share of the vocabulary changes nothing but the file's
    ``vocab_size``, which the count already reads."""
    traffic = {"batch": 1, "seq_len": 4096}
    no_vocab_share = dict(V3_RANK, shares={"n_routed_experts": V3_RANK["shares"]["n_routed_experts"]})
    assert work.train_step_flops(V3_RANK, traffic) == work.train_step_flops(no_vocab_share, traffic)


K1 = harness.load(ROOT / "cardbench/metrics/train.k1_roofline.py", "metric")


def _k1_ctx(config: dict, traffic: dict) -> dict:
    """A traced run of three steps, each with two K1 launches of 0.021 ms
    beside a GEMM."""
    events = [("bcr_match_kernel", 0.0, 0.021), ("sm90_gemm", 0.05, 1.5), ("bcr_thread_counts", 2.0, 0.021)]
    return {"busy_s": 1.0, "traced": [{"events": events} for _ in range(3)], "config": config, "traffic": traffic,
            "hw": hw}


def _parent_k1(ctx: dict) -> float:
    """``train.k1_roofline`` as it was before shares."""
    per = device_ms(ctx, K1.is_k1)
    launches = sum(1 for rec in ctx["traced"] for n, _, _ in rec["events"] if K1.is_k1(n))
    c = ctx["config"]
    nbytes = launches * work.count_rank_bytes(work.moe_assignments(c, ctx["traffic"]), c["n_routed_experts"])
    return 100.0 * nbytes / (ctx["hw"].HBM_BYTES_S / 1e3) / sum(per)


@pytest.mark.parametrize("traffic", ["2x4k", "1x8k"])
def test_k1_roofline_unchanged_without_a_share(traffic):
    ctx = _k1_ctx(V2_LITE, json.loads((ROOT / f"cardbench/traffic/{traffic}.json").read_text()))
    assert K1.read(ctx) == _parent_k1(ctx)


def test_k1_roofline_counts_the_published_experts_under_a_share():
    """One EP32 rank at 1 x 4,096: 32,768 assignments ranked into all 256
    experts, not the 8 held."""
    ctx = _k1_ctx(V3_RANK, {"batch": 1, "seq_len": 4096})
    nbytes = 6 * 4 * (2 * 32_768 + 256)
    assert K1.read(ctx) == pytest.approx(100.0 * nbytes / (hw.HBM_BYTES_S / 1e3) / (6 * 0.021), rel=1e-12)
    assert K1.read(ctx) > _parent_k1(ctx)
