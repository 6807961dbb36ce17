"""The port's Mamba2 blocks (``repro_torch.models.ssm``) and Zamba2's
shared block against the JAX package's, on the CPU.

Both sides compute on the same inputs, made with numpy from a seed, and
on the same weights (JAX's ``init`` through numpy).  Tolerances, each an
error over the larger of 1 and the reference's largest magnitude: 1e-5
for the SSD scan and the conv, 1e-4 for a whole block and for the
chunked scan against its own step-by-step decode update.  The scan's
outputs reach 40-60 on these inputs, and both packages' float32 results
lie about 1e-6 of that from a float64 sequential truth: they contract
the same products in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.common import NO_SHARD as JNO_SHARD
from repro_torch.configs import registry
from repro_torch.models import lm, ssm
from repro_torch.models.common import NO_SHARD
from repro_torch.models.convert import params_from_numpy

SSD_TOL = 1e-5
BLOCK_TOL = 1e-4
ARCH = "zamba2-2.7b"  # Mamba2 blocks and the shared block in one smoke config
Q = registry.get_config(ARCH, smoke=True).ssm.chunk_size  # 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(groups: int = 1):
    jc = jregistry.get_config(ARCH, smoke=True).replace(dtype=jnp.float32, remat=False)
    tc = registry.get_config(ARCH, smoke=True).replace(dtype=torch.float32)
    if groups != 1:
        jc = jc.replace(ssm=dataclasses.replace(jc.ssm, n_groups=groups))
        tc = tc.replace(ssm=dataclasses.replace(tc.ssm, n_groups=groups))
    return jc, tc


def err(a, b) -> float:
    """max |a - b| over max(1, max |b|): ``b`` is the reference."""
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    finite = np.isfinite(b)
    assert np.array_equal(finite, np.isfinite(a)) and np.array_equal(a[~finite], b[~finite])
    if not finite.any():
        return 0.0
    return float(np.abs(a - b)[finite].max() / max(1.0, np.abs(b[finite]).max()))


def both(x: np.ndarray):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def ssd_inputs(tc, B: int, S: int, seed: int):
    """x, dt (softplus of a normal), A (negative, per head), B, C and an
    initial state, as numpy float32."""
    g = np.random.default_rng(seed)
    nh, hd, ng, ds = tc.ssm_heads, tc.ssm.head_dim, tc.ssm.n_groups, tc.ssm.d_state
    f = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(B, S, nh))).astype(np.float32)
    A = -np.exp(0.5 * f(nh)).astype(np.float32)
    return f(B, S, nh, hd), dt, A, f(B, S, ng, ds), f(B, S, ng, ds), 0.5 * f(B, nh, hd, ds)


def ssd_sequential(x, dt, A, B_, C, init_state=None):
    """The decode update ``ssd_step`` applied position by position."""
    Bt, S, nh, hd = x.shape
    rep = nh // B_.shape[2]
    st = torch.zeros((Bt, nh, hd, B_.shape[3])) if init_state is None else init_state
    ys = []
    for t in range(S):
        y, st = ssm.ssd_step(
            st, x[:, t], dt[:, t], A, B_[:, t].repeat_interleave(rep, 1), C[:, t].repeat_interleave(rep, 1)
        )
        ys.append(y)
    return torch.stack(ys, 1), st


# ------------------------------------------------------------------ SSD scan
@pytest.mark.parametrize("with_state", (False, True), ids=("zero_state", "init_state"))
@pytest.mark.parametrize("S", (1, Q - 1, Q, Q + 1, 3 * Q + 5))
def test_ssd_chunked_matches_reference(S, with_state):
    jc, tc = cfgs()
    x, dt, A, B_, C, st = ssd_inputs(tc, 2, S, seed=S)
    init = (jnp.asarray(st), torch.from_numpy(st)) if with_state else (None, None)
    yj, fj = jssm.ssd_chunked(*(both(a)[0] for a in (x, dt, A, B_, C)), jc, init_state=init[0])
    yt, ft = ssm.ssd_chunked(*(both(a)[1] for a in (x, dt, A, B_, C)), tc, init_state=init[1])
    assert yt.dtype == ft.dtype == torch.float32
    assert err(yt, yj) <= SSD_TOL and err(ft, fj) <= SSD_TOL


@pytest.mark.parametrize("S", (Q + 1, 3 * Q + 5))
def test_ssd_chunked_with_two_groups_matches_reference(S):
    jc, tc = cfgs(groups=2)
    x, dt, A, B_, C, st = ssd_inputs(tc, 2, S, seed=7)
    yj, fj = jssm.ssd_chunked(*(both(a)[0] for a in (x, dt, A, B_, C)), jc, init_state=jnp.asarray(st))
    yt, ft = ssm.ssd_chunked(*(both(a)[1] for a in (x, dt, A, B_, C)), tc, init_state=torch.from_numpy(st))
    assert err(yt, yj) <= SSD_TOL and err(ft, fj) <= SSD_TOL


@pytest.mark.parametrize("S", (1, Q + 1, 3 * Q + 5))
def test_ssd_chunked_equals_its_decode_update_position_by_position(S):
    _, tc = cfgs(groups=2)
    x, dt, A, B_, C, st = (torch.from_numpy(a) for a in ssd_inputs(tc, 2, S, seed=11))
    y, final = ssm.ssd_chunked(x, dt, A, B_, C, tc, init_state=st)
    y_seq, final_seq = ssd_sequential(x, dt, A, B_, C, st)
    assert err(y, y_seq) <= BLOCK_TOL and err(final, final_seq) <= BLOCK_TOL


def test_segsum_is_the_masked_cumulative_sum():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32))
    got = ssm._segsum(x)
    assert err(got, jssm._segsum(jnp.asarray(x.numpy()))) <= SSD_TOL
    assert torch.isneginf(got[:, 0, 1]).all() and float(got[:, 3, 3].abs().max()) == 0.0


# -------------------------------------------------------------- causal conv
@pytest.mark.parametrize("with_state", (False, True), ids=("zero_state", "state"))
def test_causal_conv_matches_reference(with_state):
    jc, tc = cfgs()
    g = np.random.default_rng(5)
    f = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    W, Cd = tc.ssm.d_conv, 24
    xbc, w, b, st = f(2, 9, Cd), f(W, Cd), f(Cd), f(2, W - 1, Cd)
    sj, s_t = both(st) if with_state else (None, None)
    yj, sj = jssm._causal_conv(*(both(a)[0] for a in (xbc, w, b)), jc, state=sj)
    yt, s_t = ssm._causal_conv(*(both(a)[1] for a in (xbc, w, b)), tc, state=s_t)
    assert err(yt, yj) <= SSD_TOL and err(s_t, sj) <= SSD_TOL
    assert s_t.shape == (2, W - 1, Cd)


# ------------------------------------------------------------- Mamba2 block
def mamba_block(jc, seed: int = 0):
    """One Mamba2 block with non-trivial A_log, D, dt_bias, conv_b and norm scale."""
    p = jssm.init_mamba(jax.random.PRNGKey(seed), jc)
    g = np.random.default_rng(seed + 1)
    for k in ("conv_b", "A_log", "D", "dt_bias", "norm_scale"):
        p[k] = p[k] + jnp.asarray(0.3 * g.standard_normal(p[k].shape).astype(np.float32))
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def mamba_cache(tc, B: int, seed: int):
    g = np.random.default_rng(seed)
    c = ssm.init_mamba_cache(tc, B, torch.float32, "cpu")
    return {k: (0.5 * g.standard_normal(v.shape)).astype(np.float32) for k, v in c.items()}


@pytest.mark.parametrize("mode", ("train", "prefill", "prefill_one_token", "decode"))
def test_apply_mamba_matches_reference(mode):
    """``train``: no cache; ``prefill``: 37 positions (one chunk and a
    padded tail) from a non-zero cache; a one-token prefill (from the
    zero cache) and a decode step (from a non-zero one) both take the
    decode branch."""
    jc, tc = cfgs()
    pj, pt = mamba_block(jc)
    S = {"train": 37, "prefill": 37, "prefill_one_token": 1, "decode": 1}[mode]
    x = np.random.default_rng(9).standard_normal((2, S, jc.d_model)).astype(np.float32)
    cache = None if mode == "train" else mamba_cache(tc, 2, seed=10)
    if mode == "prefill_one_token":
        cache = {k: np.zeros_like(v) for k, v in cache.items()}
    yj, cj = jssm.apply_mamba(pj, jnp.asarray(x), jc, JNO_SHARD,
                              cache=None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()}, pos=5)
    ct0 = None if cache is None else {k: torch.from_numpy(v) for k, v in cache.items()}
    yt, ct = ssm.apply_mamba(pt, torch.from_numpy(x), tc, NO_SHARD, cache=ct0, pos=5)
    assert err(yt, yj) <= BLOCK_TOL
    if cache is None:
        assert cj is None and ct is None
    else:
        assert err(ct["conv"], cj["conv"]) <= BLOCK_TOL and err(ct["ssm"], cj["ssm"]) <= BLOCK_TOL
        assert all(np.array_equal(ct0[k].numpy(), cache[k]) for k in cache)  # the given cache is left alone


def test_prefill_then_decode_equals_train_on_one_block():
    """The block's own consistency: a 40-token prefill, then 3 decode
    steps, give the train outputs of all 43 positions."""
    jc, tc = cfgs()
    _, pt = mamba_block(jc, seed=2)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((2, 43, tc.d_model)).astype(np.float32))
    want, _ = ssm.apply_mamba(pt, x, tc, NO_SHARD)
    cache = {k: torch.from_numpy(np.zeros_like(v)) for k, v in mamba_cache(tc, 2, 0).items()}
    got, cache = ssm.apply_mamba(pt, x[:, :40], tc, NO_SHARD, cache=cache)
    steps = [got]
    for t in range(40, 43):
        y, cache = ssm.apply_mamba(pt, x[:, t : t + 1], tc, NO_SHARD, cache=cache, pos=t)
        steps.append(y)
    assert err(torch.cat(steps, 1), want) <= BLOCK_TOL


# ----------------------------------------------------------- shared block
@pytest.mark.parametrize("mode", ("prefill", "decode"))
def test_apply_shared_block_matches_reference(mode):
    jc, tc = cfgs()
    p = jlm.init_shared_block(jax.random.PRNGKey(4), jc)
    pt = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    g = np.random.default_rng(13)
    S = 11 if mode == "prefill" else 1
    x, x0 = (g.standard_normal((2, S, jc.d_model)).astype(np.float32) for _ in range(2))
    if mode == "prefill":
        yj, kvj = jlm.apply_shared_block(p, jnp.asarray(x), jnp.asarray(x0), jc, JNO_SHARD, positions=jnp.arange(S))
        yt, kvt = lm.apply_shared_block(pt, torch.from_numpy(x), torch.from_numpy(x0), tc, NO_SHARD,
                                        positions=torch.arange(S))
    else:
        KV, hd, pos = jc.num_kv_heads, jc.resolved_head_dim, 6
        ck, cv = (g.standard_normal((2, 9, KV, hd)).astype(np.float32) for _ in range(2))
        yj, kvj = jlm.apply_shared_block(p, jnp.asarray(x), jnp.asarray(x0), jc, JNO_SHARD,
                                         positions=pos + jnp.zeros((1,), jnp.int32),
                                         cache=(jnp.asarray(ck), jnp.asarray(cv)), pos=pos)
        yt, kvt = lm.apply_shared_block(pt, torch.from_numpy(x), torch.from_numpy(x0), tc, NO_SHARD,
                                        positions=torch.tensor([pos]),
                                        cache=(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())), pos=pos)
    assert err(yt, yj) <= BLOCK_TOL
    assert err(kvt[0], kvj[0]) <= BLOCK_TOL and err(kvt[1], kvj[1]) <= BLOCK_TOL


def test_hybrid_runs_the_shared_block_after_every_period(monkeypatch):
    jc, tc = cfgs()
    pt = lm.init(tc, torch.Generator().manual_seed(1))
    seen = []
    real = lm.apply_shared_block

    def spy(p, x, x0, cfg, rules, **kw):
        seen.append((kw.get("cache") is not None, x0.shape[1]))
        return real(p, x, x0, cfg, rules, **kw)

    monkeypatch.setattr(lm, "apply_shared_block", spy)
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, tc.vocab_size, (2, 6)))
    lm.forward(pt, {"tokens": toks}, tc)
    n_periods = tc.num_layers // tc.hybrid_period
    assert seen == [(False, 6)] * n_periods
    cache = lm.init_cache(tc, 2, 8, device="cpu")
    assert cache["shared"][0].shape == (n_periods, 2, 8, tc.num_kv_heads, tc.resolved_head_dim)
    _, cache = lm.prefill(pt, {"tokens": toks}, tc, NO_SHARD, cache)
    lm.decode_step(pt, toks[:, :1], tc, NO_SHARD, cache, 6)
    assert seen[n_periods:] == [(False, 6)] * n_periods + [(True, 1)] * n_periods
