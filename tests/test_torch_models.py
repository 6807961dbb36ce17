"""The port's model layer (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, on the CPU.

JAX parameters come from ``api.init(PRNGKey(0), cfg)``, go to numpy and
cross with ``params_from_numpy``, so both packages compute on the same
weights; inputs are made with numpy from a seed.  On the CPU the port's
MoE ``sorted`` dispatch runs the count/rank kernel's plain version.
The ssm, hybrid, encdec and vlm families run with their extra inputs:
random encoder frames (whisper) and vision embeddings over a real
(3, B, S) M-RoPE grid (qwen2-vl); the Mamba2 units are in
``tests/test_torch_ssm.py``.

Tolerances: float32 results within 1e-4 absolute (the two sides differ
only in the order of float32 sums; the logits are of order 1) and routes
(``top_e``) equal; bfloat16 results within 5e-2, routes not compared
(one bf16 rounding can flip a near tie); the port's prefill + decode
against its own forward within the reference's 2e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import MLAConfig as JMLAConfig
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import rope as jrope
from repro.models.common import NO_SHARD as JNO_SHARD
from repro_torch.configs import registry
from repro_torch.models import attention, encdec, layers, lm, mla, moe, rope
from repro_torch.models.common import NO_SHARD, layer
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

SERVED = tuple(jregistry.ARCHS)  # all ten archs, every model family
DENSE = ("minitron-4b", "qwen1.5-32b", "qwen1.5-110b", "gemma3-4b")
FAMILIES = ("mamba2-370m", "zamba2-2.7b", "whisper-tiny", "qwen2-vl-7b")  # ssm, hybrid, encdec, vlm
F32_TOL = 1e-4
BF16_TOL = 5e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny: one torch thread a test process, so this file
    does not crowd the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def err(a, b) -> float:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) if a.size else 0.0


def cfgs(arch: str, dtype: str = "f32", smoke: bool = True, **kw):
    jd, td = DTYPES[dtype]
    jc = jregistry.get_config(arch, smoke=smoke).replace(dtype=jd, remat=False, **kw)
    tc = registry.get_config(arch, smoke=smoke).replace(dtype=td, **kw)
    return jc, tc


@functools.cache
def jax_params(arch: str):
    jc = jregistry.get_config(arch, smoke=True)
    return jregistry.get_model_api(jc).init(jax.random.PRNGKey(0), jc)


def both_params(arch: str):
    jp = jax_params(arch)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def tokens(cfg, B: int, S: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).long() if x.dtype.kind == "i" else torch.from_numpy(x)


def normal(shape, seed: int, dtype: str = "f32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def cache_leaves(cache) -> list:
    """Every tensor of a cache, in the order ``jax.tree.leaves`` gives the
    reference's (dict keys sorted)."""
    return jax.tree.leaves(cache)


def model_batch(cfg, B: int, S: int, seed: int = 1) -> dict:
    """Tokens, and the family's extra inputs, as numpy: random encoder
    frames (encdec); vision embeddings over the first positions with their
    M-RoPE grid (vlm): t = 0 and (h, w) over a patch grid of width 4, then
    text positions equal on all three axes, which decode's broadcast
    position continues."""
    batch = {"tokens": tokens(cfg, B, S, seed)}
    g = np.random.default_rng(seed + 100)
    if cfg.family == "encdec":
        batch["enc_frames"] = g.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        V = cfg.vision_tokens
        batch["vision_embeds"] = g.standard_normal((B, V, cfg.d_model)).astype(np.float32)
        thw = np.broadcast_to(np.arange(S), (3, B, S)).copy()
        thw[0, :, :V], thw[1, :, :V], thw[2, :, :V] = 0, np.arange(V) // 4, np.arange(V) % 4
        batch["positions_thw"] = thw.astype(np.int32)
    return batch


def upto(batch: dict, n: int) -> dict:
    out = dict(batch, tokens=batch["tokens"][:, :n])
    if "positions_thw" in batch:
        out["positions_thw"] = batch["positions_thw"][:, :, :n]
    return out


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch: dict, device="cpu") -> dict:
    return {k: (torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)).to(device)
            for k, v in batch.items()}


def shared_wq(cfg) -> int:
    """The weights ``param_count()`` leaves out: the hybrid shared block's
    ``wq`` (a fault of the reference's count, kept by the port's copy)."""
    return cfg.d_model * cfg.num_heads * cfg.resolved_head_dim if cfg.is_hybrid else 0


# ------------------------------------------------------------ configs, init
@pytest.mark.parametrize("smoke", (False, True), ids=("full", "smoke"))
@pytest.mark.parametrize("arch", list(jregistry.ARCHS))
def test_param_count_matches_reference(arch, smoke):
    assert registry.get_config(arch, smoke).param_count() == jregistry.get_config(arch, smoke).param_count()


def test_deepseek_full_width_is_the_published_config():
    cfg = registry.get_config("deepseek-v2-lite-16b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size) == (27, 2048, 16, 102400)
    assert (cfg.mla.kv_lora_rank, cfg.mla.qk_nope_head_dim, cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim) == (512, 128, 64, 128)
    m = cfg.moe
    assert (m.num_experts, m.num_experts_per_tok, m.num_shared_experts, m.expert_d_ff) == (64, 6, 2, 1408)
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    assert cfg.param_count() == 16_210_198_528


@pytest.mark.parametrize("arch", SERVED)
def test_init_builds_the_reference_tree(arch):
    cfg = registry.get_config(arch, smoke=True)
    got = registry.get_model_api(cfg).init(cfg, torch.Generator().manual_seed(0))
    want = params_from_numpy(jax.tree.map(np.asarray, jax_params(arch)), "cpu")
    flat = lambda tree: {  # noqa: E731
        path: (tuple(t.shape), t.dtype) for path, t in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    assert flat(got) == flat(want)
    assert lm.counted_params(got) == lm.counted_params(want) == cfg.param_count() + shared_wq(cfg)


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_width_tree_counts_param_count_and_the_shared_wq(arch):
    """At full width, from the reference tree's shapes alone: the counted
    weights are ``param_count()``, plus 2560^2 = 6,553,600 for Zamba2."""
    cfg = registry.get_config(arch)
    jc = jregistry.get_config(arch)
    shapes = jax.eval_shape(lambda k: jregistry.get_model_api(jc).init(k, jc), jax.random.PRNGKey(0))
    counted = sum(
        int(np.prod(x.shape)) for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]
        if path[-1].key not in lm._UNCOUNTED
    )
    assert counted == cfg.param_count() + shared_wq(cfg)
    assert shared_wq(cfg) == (6_553_600 if arch == "zamba2-2.7b" else 0)


def test_init_is_seeded_truncated_fan_in():
    cfg = registry.get_config("deepseek-v2-lite-16b", smoke=True)
    a = lm.init(cfg, torch.Generator().manual_seed(3))
    b = lm.init(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a, is_leaf=torch.is_tensor), jax.tree.leaves(b, is_leaf=torch.is_tensor)))
    wi = a["blocks"]["moe"]["wi"]  # (L, E, d, f): fan-in d
    std = cfg.d_model ** -0.5
    assert float(wi.abs().max()) <= 2 * std + 1e-7
    assert abs(float(wi.std()) / std - 0.8796) < 0.03  # a ±2σ truncated normal's std


def test_unknown_family_raises():
    cfg = registry.get_config("gemma3-4b", smoke=True).replace(family="rnn")
    with pytest.raises(NotImplementedError, match="unknown family 'rnn'"):
        registry.get_model_api(cfg)
    with pytest.raises(NotImplementedError, match="unknown family"):
        lm.init(cfg, torch.Generator())


@pytest.mark.parametrize("arch", SERVED)
def test_get_model_api_is_the_port_lm(arch):
    """The port's ``lm``, or ``encdec`` for whisper, as the reference picks."""
    cfg = registry.get_config(arch, smoke=True)
    want = encdec if cfg.family == "encdec" else lm
    assert registry.get_model_api(cfg) is want
    ref = jregistry.get_model_api(jregistry.get_config(arch, smoke=True))
    assert ref.__name__.split(".")[-1] == want.__name__.split(".")[-1]


def test_params_from_numpy_keeps_bfloat16_bits():
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 37, dtype=np.float32), jnp.bfloat16))
    t = tensor_from_numpy(x, "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), x.view(np.int16))
    tree = params_from_numpy({"a": (x, np.arange(3, dtype=np.int32)), "b": [np.ones(2, np.float32)]}, "cpu")
    assert isinstance(tree["a"], tuple) and tree["a"][1].dtype == torch.int32 and isinstance(tree["b"], list)


# --------------------------------------------------------------- unit parity
ATTN_CASES = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=5),
    "window0_global": dict(causal=True, window=0),
    "kv_len": dict(causal=False, kv_len=13, q_offset=12),
    "chunk_remainder": dict(causal=True, chunk=7),
    "bf16_matmul": dict(causal=True, matmul_bf16=True, chunk=8),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case):
    kw = ATTN_CASES[case]
    Sq = 1 if "kv_len" in kw else 20
    qj, qt = normal((2, Sq, 4, 16), 1)
    kj, kt = normal((2, 20, 2, 16), 2)
    vj, vt = normal((2, 20, 2, 12), 3)
    want = jattention.attention(qj, kj, vj, **kw)
    got = attention.attention(qt, kt, vt, **kw)
    assert err(got, want) <= F32_TOL


def test_attention_with_ring_positions_matches_reference():
    # a ring of 16 slots: positions 28..39, rotated, and four never written
    kpos = np.full(16, attention.RING_INVALID, np.int32)
    kpos[:12] = np.arange(28, 40)
    kpos = np.roll(kpos, 5)
    qj, qt = normal((2, 1, 4, 16), 4)
    kj, kt = normal((2, 16, 2, 16), 5)
    vj, vt = normal((2, 16, 2, 16), 6)
    kw = dict(causal=False, window=10, q_offset=39, chunk=6)
    want = jattention.attention(qj, kj, vj, k_positions=jnp.asarray(kpos), **kw)
    got = attention.attention(qt, kt, vt, k_positions=torch.from_numpy(kpos), **kw)
    assert err(got, want) <= F32_TOL


def test_attention_with_lse_matches_reference():
    qj, qt = normal((2, 1, 4, 24), 7)
    kj, kt = normal((2, 18, 1, 24), 8)
    vj, vt = normal((2, 18, 1, 20), 9)
    want = jattention.attention_with_lse(qj, kj, vj, kv_len=11, scale=0.3)
    got = attention.attention_with_lse(qt, kt, vt, kv_len=11, scale=0.3)
    assert err(got[0], want[0]) <= F32_TOL and err(got[1], want[1]) <= F32_TOL


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope_and_mrope_match_reference(dtype):
    xj, xt = normal((2, 9, 3, 16), 10, dtype)
    pos = np.arange(3, 12)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    assert err(rope.apply_rope(xt, torch.from_numpy(pos), 1e6), jrope.apply_rope(xj, jnp.asarray(pos), 1e6)) <= tol
    thw = np.random.default_rng(11).integers(0, 50, (3, 2, 9)).astype(np.int32)
    got = rope.apply_mrope(xt, torch.from_numpy(thw), (4, 2, 2), 1e6)
    assert err(got, jrope.apply_mrope(xj, jnp.asarray(thw), (4, 2, 2), 1e6)) <= tol
    assert err(rope.sinusoidal_positions(10, 8), jrope.sinusoidal_positions(10, 8)) <= F32_TOL


@pytest.mark.parametrize("d_model", (64, 384))
def test_sinusoid_rows_equal_the_table_bit_for_bit(d_model):
    """Whisper's decode step computes only the row at its position."""
    table = rope.sinusoidal_positions(32776, d_model)
    for pos in (0, 1, 17, 255, 1499, 4096, 32775):
        assert torch.equal(rope.sinusoidal_positions(1, d_model, start=pos)[0], table[pos])


@pytest.mark.parametrize("norm", ("rmsnorm", "layernorm"))
def test_norms_match_reference(norm):
    jc, tc = cfgs("gemma3-4b", norm=norm)
    xj, xt = normal((2, 5, 64), 12)
    sj, st = normal((64,), 13)
    p_j, p_t = {"scale": sj, "bias": sj * 0.5}, {"scale": st, "bias": st * 0.5}
    assert err(layers.apply_norm(p_t, xt, tc), jlayers.apply_norm(p_j, xj, jc)) <= F32_TOL
    hj, ht = normal((2, 5, 4, 16), 14)
    assert err(layers.rms_norm_head(ht, st[:16]), jlayers.rms_norm_head(hj, sj[:16])) <= F32_TOL


@pytest.mark.parametrize("act", ("silu", "gelu"))
def test_mlp_matches_reference(act):
    jc, tc = cfgs("qwen1.5-32b", act=act)
    p = jlayers.init_mlp(jax.random.PRNGKey(3), 64, 128, jc)
    p = {k: v + 0.1 for k, v in p.items()}  # non-zero biases
    xj, xt = normal((2, 5, 64), 15)
    got = layers.apply_mlp(params_from_numpy(jax.tree.map(np.asarray, p), "cpu"), xt, tc, NO_SHARD)
    assert err(got, jlayers.apply_mlp(p, xj, jc, JNO_SHARD)) <= F32_TOL


def _mla_cfgs(absorb: bool, smoke: bool = True):
    jc, tc = cfgs("deepseek-v2-lite-16b", smoke=smoke)
    a = dataclasses.asdict(jc.mla) | {"absorb": absorb}
    return jc.replace(mla=JMLAConfig(**a)), tc.replace(mla=dataclasses.replace(tc.mla, absorb=absorb))


def _mla_block(jc, seed=0):
    p = jmla.init_mla(jax.random.PRNGKey(seed), jc)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("absorb", (False, True), ids=("expanded", "absorbed"))
def test_mla_prefill_and_decode_match_reference(absorb):
    jc, tc = _mla_cfgs(absorb)
    pj, pt = _mla_block(jc)
    B, S, Smax = 2, 10, 14
    xj, xt = normal((B, S, jc.d_model), 16)
    oj, (cj, krj) = jmla.mla_attention(pj, xj, jc, JNO_SHARD, positions=jnp.arange(S), chunk=4)
    ot, (ct, krt) = mla.mla_attention(pt, xt, tc, NO_SHARD, positions=torch.arange(S), chunk=4)
    assert max(err(ot, oj), err(ct, cj), err(krt, krj)) <= F32_TOL
    cache_j = jmla.init_mla_cache(jc, B, Smax, jnp.float32)
    cache_j = {"c": cache_j["c"].at[:, :S].set(cj), "kr": cache_j["kr"].at[:, :S].set(krj)}
    cache_t = {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}
    x1j, x1t = normal((B, 1, jc.d_model), 17)
    for pos in (S, Smax - 1, Smax + 2):  # the last write clamps to the end
        dj, cache_j = jmla.mla_decode(pj, x1j, jc, JNO_SHARD, cache=cache_j, pos=pos)
        dt, cache_t = mla.mla_decode(pt, x1t, tc, NO_SHARD, cache=cache_t, pos=pos)
        assert err(dt, dj) <= F32_TOL
        assert err(cache_t["c"], cache_j["c"]) <= F32_TOL and err(cache_t["kr"], cache_j["kr"]) <= F32_TOL


def test_mla_block_at_full_width_matches_reference():
    """One DeepSeek-V2-Lite MLA block at its published widths: d_model
    2048, 16 heads, latent rank 512 (13.76 M parameters)."""
    jc, tc = _mla_cfgs(False, smoke=False)
    pj, pt = _mla_block(jc, seed=5)
    assert sum(t.numel() for t in pt.values()) == 13_762_560
    xj, xt = normal((1, 6, 2048), 18)
    oj, (cj, _) = jmla.mla_attention(pj, xj, jc, JNO_SHARD, positions=jnp.arange(6))
    ot, (ct, _) = mla.mla_attention(pt, xt, tc, NO_SHARD, positions=torch.arange(6))
    assert err(ot, oj) <= F32_TOL and err(ct, cj) <= F32_TOL


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_router_matches_reference(dtype):
    jc, tc = cfgs("deepseek-v2-lite-16b", dtype)
    pj, pt = both_params("deepseek-v2-lite-16b")
    bj, bt = jax.tree.map(lambda a: a[0], pj["blocks"]["moe"]), layer(pt["blocks"]["moe"], 0)
    xj, xt = normal((3, 7, jc.d_model), 19, dtype)
    want, got = jmoe._router(bj, xj, jc), moe._router(bt, xt, tc)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    assert err(got[0], want[0]) <= tol and err(got[2], want[2]) <= tol
    if dtype == "f32":
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_router_breaks_ties_toward_the_lower_expert():
    jc, tc = cfgs("deepseek-v2-lite-16b")
    E = jc.moe.num_experts
    # equal router columns: every expert ties with its twin
    w = np.random.default_rng(20).standard_normal((jc.d_model, E // 2)).astype(np.float32)
    w = np.repeat(w, 2, axis=1)
    xj, xt = normal((2, 5, jc.d_model), 21)
    want = jmoe._router({"router": jnp.asarray(w)}, xj, jc)[1]
    got = moe._router({"router": torch.from_numpy(w)}, xt, tc)[1]
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- MoE parity
DISPATCHES = ("dense", "sorted", "argsort", "shard_map")


def _moe_cfgs(arch: str, dispatch: str, **moe_kw):
    jc, tc = cfgs(arch)
    jc = jc.replace(moe=dataclasses.replace(jc.moe, dispatch=dispatch, **moe_kw))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, dispatch=dispatch, **moe_kw))
    return jc, tc


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ("mixtral-8x22b", "deepseek-v2-lite-16b"))
def test_apply_moe_matches_reference(arch, dispatch):
    # capacity 1.0 drops assignments, so the ranks decide which survive
    jc, tc = _moe_cfgs(arch, dispatch, capacity_factor=1.0)
    pj, pt = both_params(arch)
    bj, bt = jax.tree.map(lambda a: a[0], pj["blocks"]["moe"]), layer(pt["blocks"]["moe"], 0)
    xj, xt = normal((2, 11, jc.d_model), 22)
    yj, auxj = jmoe.apply_moe(bj, xj, jc, JNO_SHARD)
    yt, auxt = moe.apply_moe(bt, xt, tc, NO_SHARD)
    assert err(yt, yj) <= F32_TOL and err(auxt, auxj) <= F32_TOL


def _deepseek_fanout(dispatch: str):
    """DeepSeek's routing fan-out (64 experts, top-6, 2 shared) at narrow
    widths, with a capacity that drops assignments."""
    kw = dict(num_experts=64, num_experts_per_tok=6, num_shared_experts=2, expert_d_ff=16, shared_d_ff=16,
              dispatch=dispatch, capacity_factor=1.25)
    jc, tc = cfgs("deepseek-v2-lite-16b")
    jc = jc.replace(moe=dataclasses.replace(jc.moe, **kw))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, **kw))
    p = jmoe.init_moe(jax.random.PRNGKey(7), jc)
    return jc, tc, p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_apply_moe_at_deepseek_fanout_matches_reference(dispatch):
    jc, tc, pj, pt = _deepseek_fanout(dispatch)
    xj, xt = normal((3, 16, jc.d_model), 23)
    yj, _ = jmoe.apply_moe(pj, xj, jc, JNO_SHARD)
    yt, _ = moe.apply_moe(pt, xt, tc, NO_SHARD)
    assert err(yt, yj) <= F32_TOL


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sorted_and_argsort_dispatch_are_bit_identical(dtype, monkeypatch):
    calls = []
    real = moe.ops.bucket_count_rank
    monkeypatch.setattr(moe.ops, "bucket_count_rank", lambda ids, nb: calls.append(nb) or real(ids, nb))
    _, tc, _, pt = _deepseek_fanout("sorted")
    tc = tc.replace(dtype=DTYPES[dtype][1])
    _, xt = normal((4, 16, tc.d_model), 24, dtype)
    y_sorted, _ = moe.apply_moe(pt, xt, tc, NO_SHARD)
    assert calls == [64]  # one count/rank call serves the counts and the ranks
    y_argsort, _ = moe.apply_moe(pt, xt, tc.replace(moe=dataclasses.replace(tc.moe, dispatch="argsort")), NO_SHARD)
    assert calls == [64]
    assert torch.equal(y_sorted, y_argsort)


@pytest.mark.parametrize("num_assignments", (6, 96, 4512, 288))
@pytest.mark.parametrize("cf", (1.0, 1.25, 4.0, 64.0))
def test_capacity_is_the_reference_arithmetic(num_assignments, cf):
    _, tc = _moe_cfgs("deepseek-v2-lite-16b", "sorted", capacity_factor=cf, num_experts=64)
    want = int(-(-num_assignments * cf // 64))
    want += (-want) % 8
    assert moe.capacity(num_assignments, tc) == want and want % 8 == 0


# --------------------------------------------------------------- model parity
def _model_run(arch: str, dtype: str = "f32", B: int = 2, S: int = 24, **kw):
    """forward, prefill on S - 2 tokens and two decode steps, on both sides."""
    jc, tc = cfgs(arch, dtype, **kw)
    japi, tapi = jregistry.get_model_api(jc), registry.get_model_api(tc)
    pj, pt = both_params(arch)
    batch = model_batch(jc, B, S)
    toks = batch["tokens"]
    out = {"forward": (tapi.forward(pt, torch_batch(batch), tc)[0],
                       japi.forward(pj, jax_batch(batch), jc, JNO_SHARD)[0])}
    cj = japi.init_cache(jc, B, S + 4)
    ct = tapi.init_cache(tc, B, S + 4, device="cpu")
    lj, cj = japi.prefill(pj, jax_batch(upto(batch, S - 2)), jc, JNO_SHARD, cj)
    lt, ct = tapi.prefill(pt, torch_batch(upto(batch, S - 2)), tc, NO_SHARD, ct)
    out["prefill"] = (lt, lj)
    out["prefill_cache"] = (cache_leaves(ct), jax.tree.leaves(cj))
    for pos in (S - 2, S - 1):
        lj, cj = japi.decode_step(pj, jnp.asarray(toks[:, pos : pos + 1]), jc, JNO_SHARD, cj, pos)
        lt, ct = tapi.decode_step(pt, _t(toks[:, pos : pos + 1]), tc, NO_SHARD, ct, pos)
        out[f"decode@{pos}"] = (lt, lj)
    out["decode_cache"] = (cache_leaves(ct), jax.tree.leaves(cj))
    return out, toks


@pytest.mark.parametrize("arch", SERVED)
def test_forward_prefill_decode_match_reference_f32(arch):
    out, _ = _model_run(arch)
    for what, (got, want) in out.items():
        if what.endswith("cache"):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert err(g, w) <= F32_TOL, what
        else:
            assert err(got, want) <= F32_TOL, what


def test_ring_cache_past_its_window_matches_reference():
    """Mixtral's ring cache (window 32) with a 38-token prompt: the prefill
    keeps the last 32 positions in rotated slots and decode overwrites
    the oldest."""
    out, _ = _model_run("mixtral-8x22b", S=40)
    assert out["prefill_cache"][0][0].shape[2] == 32  # (L, B, ring, KV, hd)
    for what, (got, want) in out.items():
        pairs = zip(got, want) if what.endswith("cache") else [(got, want)]
        for g, w in pairs:
            assert err(g, w) <= F32_TOL, what


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_reference_bf16(arch):
    out, _ = _model_run(arch, "bf16")
    for what, (got, want) in out.items():
        if not what.endswith("cache"):
            assert err(got, want) <= BF16_TOL, what


# ``attn_matmul_bf16`` rounds the attention operands to bf16: where the
# two sides' float32 scores differ in the last bit, a rounding may land one
# bf16 step (2^-8 of an O(1) value) apart, so that lever is held to 1e-2.
LEVER_TOL = {"attn_matmul_bf16": 1e-2, "prefill_inscan_cache": F32_TOL}


@pytest.mark.parametrize("lever", list(LEVER_TOL))
@pytest.mark.parametrize("arch", ("gemma3-4b", "deepseek-v2-lite-16b"))
def test_perf_levers_match_reference(arch, lever):
    out, _ = _model_run(arch, **{lever: True})
    for what, (got, want) in out.items():
        pairs = zip(got, want) if what.endswith("cache") else [(got, want)]
        for g, w in pairs:
            assert err(g, w) <= LEVER_TOL[lever], what


@pytest.mark.parametrize("arch", SERVED)
def test_port_prefill_decode_matches_its_forward(arch):
    """The reference's serve-consistency test over the port alone."""
    _, tc = cfgs(arch)
    _, pt = both_params(arch)
    api = registry.get_model_api(tc)
    B, S = 2, 24
    batch = model_batch(tc, B, S)
    toks = _t(batch["tokens"])
    logits, _ = api.forward(pt, torch_batch(batch), tc)
    cache = api.init_cache(tc, B, S + 4, device="cpu")
    last, cache = api.prefill(pt, torch_batch(upto(batch, S - 2)), tc, NO_SHARD, cache)
    errs = [err(last, logits[:, S - 3])]
    for pos in (S - 2, S - 1):
        lg, cache = api.decode_step(pt, toks[:, pos : pos + 1], tc, NO_SHARD, cache, pos)
        errs.append(err(lg, logits[:, pos]))
    assert max(errs) < 2e-2, errs


@pytest.mark.parametrize("arch", ("mamba2-370m", "zamba2-2.7b"))
def test_ssm_prefill_past_two_chunks_matches_reference(arch):
    """A 75-token prompt over chunks of 32: the inter-chunk recurrence
    and the padded tail, then decode from the states it leaves."""
    out, _ = _model_run(arch, S=77)
    for what, (got, want) in out.items():
        pairs = zip(got, want) if what.endswith("cache") else [(got, want)]
        for g, w in pairs:
            assert err(g, w) <= F32_TOL, what


def test_one_token_ssm_prefill_takes_the_decode_branch_as_the_reference():
    jc, tc = cfgs("mamba2-370m")
    pj, pt = both_params("mamba2-370m")
    toks = tokens(jc, 2, 1)
    japi = jregistry.get_model_api(jc)
    lj, cj = japi.prefill(pj, {"tokens": jnp.asarray(toks)}, jc, JNO_SHARD, japi.init_cache(jc, 2, 4))
    lt, ct = lm.prefill(pt, {"tokens": _t(toks)}, tc, NO_SHARD, lm.init_cache(tc, 2, 4, device="cpu"))
    assert err(lt, lj) <= F32_TOL
    assert all(err(g, w) <= F32_TOL for g, w in zip(cache_leaves(ct), jax.tree.leaves(cj)))


def test_encode_and_cross_cache_match_reference():
    """Whisper's encoder output, and the cross-attention K/V that prefill
    computes once and decode reads unchanged."""
    jc, tc = cfgs("whisper-tiny")
    japi = jregistry.get_model_api(jc)
    pj, pt = both_params("whisper-tiny")
    batch = model_batch(jc, 2, 9)
    ej = japi.encode(pj, jnp.asarray(batch["enc_frames"]), jc, JNO_SHARD)
    et = encdec.encode(pt, torch.from_numpy(batch["enc_frames"]), tc, NO_SHARD)
    assert err(et, ej) <= F32_TOL
    _, cj = japi.prefill(pj, jax_batch(batch), jc, JNO_SHARD, japi.init_cache(jc, 2, 12))
    _, ct = encdec.prefill(pt, torch_batch(batch), tc, NO_SHARD, encdec.init_cache(tc, 2, 12, device="cpu"))
    assert ct["cross"][0].shape == (tc.num_layers, 2, tc.encoder_seq_len, tc.num_kv_heads, tc.resolved_head_dim)
    for g, w in zip(ct["cross"], cj["cross"]):
        assert err(g, w) <= F32_TOL
    _, ct2 = encdec.decode_step(pt, _t(batch["tokens"][:, :1]), tc, NO_SHARD, ct, 9)
    assert ct2["cross"] is ct["cross"]


def test_vlm_forward_with_vision_embeds_and_mrope_matches_reference():
    """qwen2-vl: the vision embeddings replace the first positions, and
    M-RoPE reads the (3, B, S) grid: both change the logits."""
    jc, tc = cfgs("qwen2-vl-7b")
    pj, pt = both_params("qwen2-vl-7b")
    batch = model_batch(jc, 2, 20)
    want = jregistry.get_model_api(jc).forward(pj, jax_batch(batch), jc, JNO_SHARD)[0]
    got = lm.forward(pt, torch_batch(batch), tc)[0]
    assert err(got, want) <= F32_TOL
    plain = lm.forward(pt, {"tokens": _t(batch["tokens"])}, tc)[0]
    no_grid = lm.forward(pt, torch_batch({k: v for k, v in batch.items() if k != "positions_thw"}), tc)[0]
    assert err(plain, got) > 1e-3 and err(no_grid, got) > 1e-3


def test_mla_absorbed_equals_expanded_in_the_model():
    _, tc = cfgs("deepseek-v2-lite-16b")
    _, pt = both_params("deepseek-v2-lite-16b")
    toks = _t(tokens(tc, 2, 16))
    cache = lm.init_cache(tc, 2, 18, device="cpu")
    _, cache = lm.prefill(pt, {"tokens": toks[:, :-1]}, tc, NO_SHARD, cache)
    outs = [
        lm.decode_step(pt, toks[:, -1:], tc.replace(mla=dataclasses.replace(tc.mla, absorb=a)), NO_SHARD, cache, 15)[0]
        for a in (False, True)
    ]
    assert err(outs[0], outs[1]) <= 1e-3


@pytest.mark.parametrize(
    "arch", ("mixtral-8x22b", "qwen1.5-32b", "deepseek-v2-lite-16b", "mamba2-370m", "zamba2-2.7b", "whisper-tiny")
)
def test_prefill_and_decode_leave_the_given_cache_alone(arch):
    _, tc = cfgs(arch)
    _, pt = both_params(arch)
    api = registry.get_model_api(tc)
    batch = torch_batch(model_batch(tc, 2, 8))
    toks = batch["tokens"]
    cache0 = api.init_cache(tc, 2, 12, device="cpu")
    snap = [t.clone() for t in cache_leaves(cache0)]
    _, cache1 = api.prefill(pt, dict(batch, tokens=toks[:, :6]), tc, NO_SHARD, cache0)
    assert all(torch.equal(a, b) for a, b in zip(cache_leaves(cache0), snap))
    snap1 = [t.clone() for t in cache_leaves(cache1)]
    a, _ = api.decode_step(pt, toks[:, 6:7], tc, NO_SHARD, cache1, 6)
    b, _ = api.decode_step(pt, toks[:, 6:7], tc, NO_SHARD, cache1, 6)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(cache_leaves(cache1), snap1))


@pytest.mark.parametrize("arch", ("qwen1.5-110b", "deepseek-v2-lite-16b"))
def test_decode_past_the_cache_end_clamps_like_the_reference(arch):
    jc, tc = cfgs(arch)
    japi = jregistry.get_model_api(jc)
    pj, pt = both_params(arch)
    toks = tokens(jc, 2, 8)
    cj, ct = japi.init_cache(jc, 2, 8), lm.init_cache(tc, 2, 8, device="cpu")
    _, cj = japi.prefill(pj, {"tokens": jnp.asarray(toks[:, :7])}, jc, JNO_SHARD, cj)
    _, ct = lm.prefill(pt, {"tokens": _t(toks[:, :7])}, tc, NO_SHARD, ct)
    for pos in (7, 8, 10):
        lj, cj = japi.decode_step(pj, jnp.asarray(toks[:, 7:8]), jc, JNO_SHARD, cj, pos)
        lt, ct = lm.decode_step(pt, _t(toks[:, 7:8]), tc, NO_SHARD, ct, pos)
        assert err(lt, lj) <= F32_TOL
        assert all(err(g, w) <= F32_TOL for g, w in zip(cache_leaves(ct), jax.tree.leaves(cj)))
