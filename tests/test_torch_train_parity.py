"""The port's train step (``repro_torch.train.train_step``) against the JAX
package's ``make_train_step``, on the CPU, two steps from one state.

Both start from the reference's ``init_train_state(PRNGKey(0))``, carried
across with ``state_from_numpy``, and take the same two
``SyntheticLMData`` batches (float32 compute).  Step 1 runs at lr 0 (the
warmup's first step); step 2 at the peak lr.

Tolerances:

* metrics of both steps within 1e-4 of ``max(1, |value|)``;
* parameters after step 2: AdamW moves an entry by ``lr·(m̂/(√v̂+ε) +
  wd·p)``, and at count 2 ``|m̂|/√v̂ ≤ 1.0004`` (Cauchy–Schwarz over the
  two bias-corrected gradients), so two implementations whose gradients
  differ in float32 rounding can differ by at most ``2·lr·1.0004`` in an
  entry whose two gradients are both near zero (there the ratio's sign
  and size are rounding noise).  Every entry is held to that bound plus
  1e-6 of the leaf's largest magnitude, and all but 1 % of each leaf's
  entries to 1 % of the lr step plus 1e-6 of that magnitude;
* ``master_weights``: the float32 master as the parameters above; the
  bf16 live parameters equal the port's own master rounded to bf16, and
  lie within the master's bound plus one bf16 ulp of the reference's;
* with ``master_weights`` the gradients are bf16, as in the reference,
  so ``grad_norm`` and ``clip_scale`` are held to one bf16 ulp (2^-8)
  relative: a gradient entry that rounds to the other bf16 neighbour
  moves the norm by at most that;
* the int8 error feedback: the residual ``g + e − deq`` carries the
  gradient's float32 rounding, so all but 1 % of each leaf's entries are
  held to 1e-4 of the gradient's scale, 127 quantisation steps, a step
  being at least twice the largest residual; the rest differ by one step
  (a rounding flip of ``g/scale`` at a half, where the residual is half a
  step, so a step is at most twice the largest residual);
``grad_accum`` is held to the reference in ``tests/test_torch_train_accum.py``,
with these helpers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.common import NO_SHARD as JNO_SHARD
from repro.train.train_step import init_train_state as jinit_state
from repro.train.train_step import make_train_step as jmake_step
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.convert import state_from_numpy
from repro_torch.train.train_step import jit_train_step, make_train_step

ARCHS = tuple(jregistry.ARCHS)
B, S = 4, 32
LR = 3e-4
ADAM_RATIO = 1.0004  # the largest |m̂|/√v̂ at count 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one torch thread a test process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree) -> dict:
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


def configs(arch: str, **run_kw):
    jc = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32, remat=False)
    tc = registry.get_config(arch, smoke=True).replace(dtype=torch.float32)
    kw = dict(learning_rate=LR, warmup_steps=1, total_steps=4, **run_kw)
    jrun = JRunConfig(model=jc, shape=JShapeConfig("t", S, B, "train"), **kw)
    trun = RunConfig(model=tc, shape=ShapeConfig("t", S, B, "train"), **kw)
    return jc, tc, jrun, trun


@functools.cache
def reference_run(arch: str, **run_kw):
    """(initial state as numpy, metrics of two steps, final state as numpy)."""
    jc, _, jrun, _ = configs(arch, **run_kw)
    api = jregistry.get_model_api(jc)
    state = jinit_state(jax.random.PRNGKey(0), jc, jrun, api)
    start = jax.tree.map(np.asarray, state)
    step = jax.jit(jmake_step(jc, jrun, api, JNO_SHARD))
    data = JData(jc, B, S, seed=0)
    metrics = []
    for _ in range(2):
        state, m = step(state, data.next_batch())
        metrics.append({k: float(v) for k, v in m.items()})
    return start, metrics, jax.tree.map(np.asarray, state)


def port_run(arch: str, start=None, **run_kw):
    """Two port steps from the reference's initial state."""
    _, tc, _, trun = configs(arch, **run_kw)
    if start is None:
        start = reference_run(arch, **run_kw)[0]
    state = state_from_numpy(start, "cpu")
    step = jit_train_step(make_train_step(tc, trun, registry.get_model_api(tc)))
    data = SyntheticLMData(tc, B, S, seed=0)
    metrics = []
    for _ in range(2):
        state, m = step(state, data.next_batch())
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def check_metrics(got: list, want: list, bf16_grads: bool = False):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            tol = 2.0**-8 if bf16_grads and k in ("grad_norm", "clip_scale") else 1e-4
            assert abs(g[k] - w[k]) <= tol * max(1.0, abs(w[k])), (k, g[k], w[k])
    assert got[0]["lr"] == 0.0 and abs(got[1]["lr"] - LR) <= 1e-7 * LR


def check_float_leaves(got: dict, want: dict, lr: float = LR):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = np.abs(got[k] - w)
        assert float(err.max()) <= 2 * lr * ADAM_RATIO + 1e-6 * scale, (k, float(err.max()))
        outside = float(np.mean(err > 1e-2 * lr + 1e-6 * scale))
        assert outside <= 0.01, (k, outside)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_reference(arch):
    start, want_metrics, want = reference_run(arch)
    metrics, state = port_run(arch)
    check_metrics(metrics, want_metrics)
    check_float_leaves(flat(state["params"]), flat(want["params"]))
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2
    assert metrics[1]["grad_norm"] > 0


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("arch", ("minitron-4b", "deepseek-v2-lite-16b"))
def test_master_weights_match_reference(arch):
    start, want_metrics, want = reference_run(arch, master_weights=True)
    metrics, state = port_run(arch, master_weights=True)
    check_metrics(metrics, want_metrics, bf16_grads=True)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(state["params"]))
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(state["opt"]["master"]))
    check_float_leaves(flat(state["opt"]["master"]), flat(want["opt"]["master"]))
    for p, m in zip(jax.tree.leaves(state["params"]), jax.tree.leaves(state["opt"]["master"])):
        assert torch.equal(p, m.to(torch.bfloat16))
    got, bf = flat(state["params"]), flat(want["params"])
    for k, w in bf.items():
        assert np.all(np.abs(got[k] - w) <= bf16_ulp(w) + 2 * LR * ADAM_RATIO), k


def test_int8_compression_step_matches_reference():
    start, want_metrics, want = reference_run("minitron-4b", grad_compression="int8")
    metrics, state = port_run("minitron-4b", grad_compression="int8")
    check_metrics(metrics, want_metrics)
    check_float_leaves(flat(state["params"]), flat(want["params"]))
    got, fb = flat(state["error_fb"]), flat(want["error_fb"])
    assert set(got) == set(fb)
    for k, w in fb.items():
        largest = max(float(np.abs(w).max()), float(np.abs(got[k]).max()))
        err = np.abs(got[k] - w)
        assert float(np.mean(err > 1e-4 * 127 * 2 * largest)) <= 0.01, k
        assert float(err.max()) <= 2 * largest * (1 + 1e-6), k
