"""The port's training numerics (``repro_torch.train``, ``repro_torch.optim``)
against the JAX package's, on the CPU.

Units: ``lm_loss`` within 1e-6 relative (about eight float32 ulps: the
means sum in another order), ``cosine_warmup`` within 1e-7 relative,
one ``adamw_update`` on the same numpy trees within 1e-6 of each leaf's
largest magnitude (the two sides round ``b ** count``, ``sqrt`` and the
fused adds apart by an ulp at most; a parameter that the step brings near
zero keeps that absolute error, not its relative one), the int8 quantiser and ``compress_grads`` bit for bit.

Per arch (the ten smoke configs in float32): from the same weights (JAX
``init`` → numpy → ``params_from_numpy``) and the same ``SyntheticLMData``
batch, the loss, the MoE aux and every gradient leaf against
``jax.value_and_grad`` of the reference's loss, within 1e-4 of each
leaf's largest magnitude (float32 sums in another order; the routes are
equal, as in ``tests/test_torch_models.py``).  And remat: the port's
loss and gradients with ``remat=True`` equal those with ``remat=False``
bit for bit, and the count/rank call runs twice a MoE layer with remat
(the forward and the backward's recompute), once without.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.common import NO_SHARD as JNO_SHARD
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim.schedules import cosine_warmup as jcosine
from repro.train.loss import lm_loss as jlm_loss
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import moe
from repro_torch.models.common import tree_unflatten
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw, compression
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.train.loss import lm_loss
from repro_torch.train.train_step import make_grad_fn

ARCHS = tuple(jregistry.ARCHS)
MOE = ("mixtral-8x22b", "deepseek-v2-lite-16b")
B, S = 2, 32
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one torch thread a test process, so this file does
    not crowd the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree) -> dict:
    """``{path: numpy float64 array}`` of a tree of JAX arrays or tensors."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{prefix}/{i}")
        else:
            a = t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
            out[prefix] = a.astype(np.float64)

    walk(tree, "")
    return out


def cfgs(arch: str, **kw):
    jc = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32, **{**kw, "remat": False})
    tc = registry.get_config(arch, smoke=True).replace(dtype=torch.float32, **kw)
    return jc, tc


@functools.cache
def jax_params(arch: str):
    jc, _ = cfgs(arch)
    return jregistry.get_model_api(jc).init(jax.random.PRNGKey(0), jc)


def batches(jc, tc, b=B, s=S):
    """The same synthetic batch from both pipelines."""
    return JData(jc, b, s, seed=0).next_batch(), SyntheticLMData(tc, b, s, seed=0).next_batch()


# ---------------------------------------------------------------- units
def test_lm_loss_matches_reference():
    g = np.random.default_rng(0)
    logits = (g.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = g.integers(0, 50, (3, 7)).astype(np.int32)
    want, wm = jlm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got, gm = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels).long())
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    for k in ("ce", "z_loss", "accuracy"):
        assert abs(float(gm[k]) - float(wm[k])) <= 1e-6 * abs(float(wm[k])), k


@pytest.mark.parametrize("step", (0, 1, 50, 100, 550, 1000, 1200))
def test_cosine_warmup_matches_reference(step):
    kw = dict(peak_lr=3e-4, warmup=100, total=1000)
    want = float(jcosine(jnp.int32(step), **kw))
    got = cosine_warmup(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-7 * abs(want)
    if step == 0:
        assert float(got) == 0.0


def random_tree(g, dtype=np.float32):
    return {
        "a": (g.standard_normal((5, 7)) * 0.3).astype(dtype),
        "b": {"c": g.standard_normal((11,)).astype(dtype), "d": (g.standard_normal((2, 3, 4)) * 1e-3).astype(dtype)},
    }


@pytest.mark.parametrize("clip", (100.0, 1e-3), ids=("unclipped", "clipped"))
def test_adamw_update_matches_reference(clip):
    g = np.random.default_rng(1)
    params, grads = random_tree(g), random_tree(g)
    m, v = random_tree(g), jax.tree.map(lambda x: np.abs(x) * 0.01, random_tree(g))
    cfg_j = jadamw.AdamWConfig(grad_clip=clip)
    cfg_t = adamw.AdamWConfig(grad_clip=clip)
    lr = np.float32(2e-3)
    jstate = {"m": m, "v": v, "count": jnp.int32(3)}
    jp, js, jm = jadamw.adamw_update(params, grads, jstate, jnp.float32(lr), cfg_j)
    tp = params_from_numpy(params, "cpu")
    ts = {"m": params_from_numpy(m, "cpu"), "v": params_from_numpy(v, "cpu"), "count": torch.tensor(3, dtype=torch.int32)}
    tm = adamw.adamw_update(tp, params_from_numpy(grads, "cpu"), ts, torch.tensor(lr), cfg_t)
    assert int(ts["count"]) == int(js["count"]) == 4
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        fg, fw = flat(got), flat(want)
        for k in fw:
            np.testing.assert_allclose(fg[k], fw[k], rtol=0, atol=1e-6 * np.abs(fw[k]).max(), err_msg=k)
    for k in ("grad_norm", "clip_scale"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k])), k
    assert (float(tm["clip_scale"]) < 1.0) == (clip < 1.0)


def test_int8_quantiser_and_compression_are_bit_equal():
    g = np.random.default_rng(2)
    x = (g.standard_normal(1000) * 3e-3).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.5e-3, -1.5e-3]
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = compression.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    jd = np.asarray(jcomp.dequantize_int8(jq, js))
    td = compression.dequantize_int8(tq, ts).numpy()
    assert td.tobytes() == jd.tobytes()

    grads, fb = random_tree(g), jax.tree.map(lambda a: (a * 1e-4).astype(np.float32), random_tree(g))
    jg, jfb = jcomp.compress_grads(grads, fb)
    tg, tfb = compression.compress_grads(params_from_numpy(grads, "cpu"), params_from_numpy(fb, "cpu"))
    for got, want in ((tg, jg), (tfb, jfb)):
        fg, fw = flat(got), flat(want)
        for k in fw:
            assert fg[k].astype(np.float32).tobytes() == fw[k].astype(np.float32).tobytes(), k
    zeros = compression.init_error_fb(params_from_numpy(grads, "cpu"))
    assert all(float(z.abs().sum()) == 0 and z.dtype == torch.float32 for z in jax.tree.leaves(zeros))


# ------------------------------------------------------------ loss and grads
@functools.cache
def jax_loss_and_grads(arch: str):
    jc, tc = cfgs(arch)
    api = jregistry.get_model_api(jc)
    jbatch, _ = batches(jc, tc)

    def loss_fn(params, batch):
        logits, aux = api.forward(params, batch, jc, JNO_SHARD)
        loss, _ = jlm_loss(logits, batch["labels"])
        return loss + aux, aux

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jax_params(arch), jbatch)
    return float(loss), float(aux), flat(grads)


def port_loss_and_grads(arch: str, **kw):
    jc, tc = cfgs(arch, **kw)
    _, tbatch = batches(jc, tc)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params(arch)), "cpu")
    run = RunConfig(model=tc, shape=ShapeConfig("t", S, B, "train"))
    loss, _, aux, grads = make_grad_fn(tc, run, registry.get_model_api(tc))(params, tbatch)
    return loss, aux, tree_unflatten(params, grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    want_loss, want_aux, want = jax_loss_and_grads(arch)
    loss, aux, grads = port_loss_and_grads(arch)
    assert abs(float(loss) - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    assert abs(float(aux) - want_aux) <= 1e-6
    got = flat(grads)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= GRAD_TOL * scale, f"{k}: {err:.3e} of {scale:.3e}"
    assert any(float(np.abs(w).max()) > 0 for w in want.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_and_reruns_the_count_rank(arch, monkeypatch):
    calls = []
    real = moe.ops.bucket_count_rank
    monkeypatch.setattr(moe.ops, "bucket_count_rank", lambda ids, nb: calls.append(nb) or real(ids, nb))
    results = {}
    for remat in (False, True):
        calls.clear()
        loss, aux, grads = port_loss_and_grads(arch, remat=remat)
        results[remat] = (loss, aux, flat(grads), len(calls))
    (l0, a0, g0, n0), (l1, a1, g1, n1) = results[False], results[True]
    assert float(l0) == float(l1) and float(a0) == float(a1)
    for k in g0:
        assert g0[k].tobytes() == g1[k].tobytes(), k
    layers = registry.get_config(arch, smoke=True).num_layers
    if arch in MOE:
        assert (n0, n1) == (layers, 2 * layers)
    else:
        assert n0 == n1 == 0


def test_runconfig_copies_the_reference():
    """Every field of the reference's ``RunConfig`` exists in the port's
    with the same default, except the checkpoint directory (under the
    temporary directory in both, the port's own name)."""
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(JRunConfig)}
    got = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    assert set(got) == set(want)
    for k in want:
        if k in ("model", "shape", "checkpoint_dir"):
            continue
        assert got[k] == want[k], k
    s = JRunConfig().shape
    assert RunConfig().shape == ShapeConfig(s.name, s.seq_len, s.global_batch, s.kind)
