"""The port's ``Trainer``, checkpointer, data pipeline and training launcher
on the CPU: the reference's ``tests/test_train_infra.py`` over the port
(``device="cpu"``), the pipeline's batches against the reference's bit
for bit, the port's trainer started from the reference trainer's state
(losses within 1e-4 over three steps, float32), and
``python -m repro_torch.launch.train`` in a subprocess."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro.train.trainer import Trainer as JTrainer
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import state_from_numpy
from repro_torch.optim.compression import compress_grads, init_error_fb
from repro_torch.train.trainer import RecoverableFailure, Trainer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one torch thread a test process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmpdir, **kw):
    cfg = registry.get_config("minitron-4b", smoke=True).replace(remat=False)
    api = registry.get_model_api(cfg)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                    checkpoint_dir=str(tmpdir), checkpoint_every=3,
                    total_steps=30, warmup_steps=2, learning_rate=1e-3, **kw)
    return cfg, api, run


# ------------------------------------------- the reference's infra tests
def test_loss_decreases(tmp_path):
    cfg, api, run = _run(tmp_path / "a")
    tr = Trainer(cfg, run, api, device="cpu")
    log = tr.run_steps(10)
    assert log[-1]["loss"] < log[0]["loss"]


def test_fault_injection_recovers(tmp_path):
    cfg, api, run = _run(tmp_path / "b")
    hits = {4, 7}

    def hook(step):
        if step in hits:
            hits.discard(step)
            raise RecoverableFailure(step)

    tr = Trainer(cfg, run, api, device="cpu", fault_hook=hook, sync_checkpoints=True)
    log = tr.run_steps(10)
    assert tr.restarts == 2
    assert not hits  # both injected failures fired
    assert len(log) == 10
    assert np.isfinite(log[-1]["loss"])


def test_resume_from_checkpoint(tmp_path):
    cfg, api, run = _run(tmp_path / "c")
    tr = Trainer(cfg, run, api, device="cpu")
    tr.run_steps(7)  # checkpoints at 3, 6
    tr.ckpt.wait()
    tr2 = Trainer(cfg, run, api, device="cpu")
    assert int(tr2.state["step"]) == 6
    assert tr2.data.step == 6  # data pipeline state restored too
    for a, b in zip(tree_leaves(tr2.state["params"]), tree_leaves(tr.state["params"])):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path / "d"), keep=2)
    tree = {
        "a": torch.arange(10),
        "b": [torch.ones((3, 3)), torch.zeros(2, dtype=torch.int32)],
        "c": torch.tensor([1.5, -0.0, 3e-40], dtype=torch.bfloat16),
        "d": torch.tensor([True, False]),
    }
    for s in (1, 2, 3):
        ck.save(s, tree, extra={"x": s}, async_save=s == 3)
    ck.wait()
    assert ck.steps() == [2, 3]  # gc keeps last 2
    out, extra = ck.restore(3, {"a": None, "b": [None, None], "c": None, "d": None})
    assert extra["x"] == 3
    for got, want in zip(tree_leaves(out), tree_leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype == torch.bfloat16 else want)


def test_bf16_master_weights_state_round_trips(tmp_path):
    cfg, api, run = _run(tmp_path / "m", master_weights=True)
    tr = Trainer(cfg, run, api, device="cpu", sync_checkpoints=True)
    tr.run_steps(3)  # a checkpoint at 3
    tr2 = Trainer(cfg, run, api, device="cpu")
    assert int(tr2.state["step"]) == 3
    for path in ("params", ("opt", "master"), ("opt", "m")):
        a = tr.state[path] if isinstance(path, str) else tr.state[path[0]][path[1]]
        b = tr2.state[path] if isinstance(path, str) else tr2.state[path[0]][path[1]]
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert x.dtype == y.dtype
            assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                               y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(tr2.state["params"]))


def test_int8_compression_error_feedback_converges(rng):
    """EF makes the *accumulated* quantised gradient track the true sum."""
    g_true = torch.from_numpy(rng.normal(0, 1e-4, (128,)).astype(np.float32))
    fb = init_error_fb({"g": g_true})
    acc_q = torch.zeros_like(g_true)
    for _ in range(50):
        dg, fb = compress_grads({"g": g_true}, fb)
        acc_q = acc_q + dg["g"]
    err = float((acc_q - 50 * g_true).abs().max()) / float((50 * g_true).abs().max())
    assert err < 0.02


# --------------------------------------------------- against the reference
@pytest.mark.parametrize("arch", ("minitron-4b", "whisper-tiny", "qwen2-vl-7b"))
def test_synthetic_batches_equal_reference(arch):
    """Three batches of a dense, an encdec and a vlm arch in its own dtype
    (bf16 frames and vision embeddings): bit for bit."""
    jc, tc = jregistry.get_config(arch, smoke=True), registry.get_config(arch, smoke=True)
    jd, td = JData(jc, 3, 16, seed=5), SyntheticLMData(tc, 3, 16, seed=5)
    for _ in range(3):
        want, got = jd.next_batch(), td.next_batch()
        assert set(got) == set(want)
        for k, w in want.items():
            g, w = got[k], np.asarray(w)
            if k in ("tokens", "labels"):
                assert g.dtype == torch.int64
                np.testing.assert_array_equal(g.numpy(), w)
            elif g.dtype == torch.bfloat16:
                assert w.dtype.name == "bfloat16"
                np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
            else:
                assert str(g.dtype).removeprefix("torch.") == w.dtype.name, k
                np.testing.assert_array_equal(g.numpy(), w)
    assert td.state() == jd.state() == {"seed": 5, "step": 3}


def test_trainer_from_reference_state_gives_its_losses(tmp_path):
    jc = jregistry.get_config("minitron-4b", smoke=True).replace(dtype=jnp.float32, remat=False)
    tc = registry.get_config("minitron-4b", smoke=True).replace(dtype=torch.float32)
    kw = dict(total_steps=10, warmup_steps=1, learning_rate=1e-3, checkpoint_every=0)
    jtr = JTrainer(jc, JRunConfig(model=jc, shape=JShapeConfig("t", 32, 4, "train"),
                                  checkpoint_dir=str(tmp_path / "j"), **kw), jregistry.get_model_api(jc))
    start = jax.tree.map(np.asarray, jtr.state)
    want = [m["loss"] for m in jtr.run_steps(3)]
    tr = Trainer(tc, RunConfig(model=tc, shape=ShapeConfig("t", 32, 4, "train"),
                               checkpoint_dir=str(tmp_path / "t"), **kw), registry.get_model_api(tc), device="cpu")
    tr.state = state_from_numpy(start, "cpu")
    got = [m["loss"] for m in tr.run_steps(3)]
    assert want[2] < want[0]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * max(1.0, abs(w)), (got, want)


# --------------------------------------------------------------- launcher
def _launch(*args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args, "--ckpt-dir", str(tmp_path / "ck")]
    return subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)


def test_launch_train_on_the_cpu(tmp_path):
    r = _launch("--arch", "minitron-4b", "--smoke", "--device", "cpu", "--steps", "3", tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("training minitron-4b (123,584 params) for 3 steps on 1 device(s)")
    assert lines[1].startswith("loss: ") and "stragglers=" in lines[1] and "restarts=0" in lines[1]
    first, last = (float(x) for x in lines[1].split(";")[0].removeprefix("loss: ").split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


def test_launch_train_on_cuda_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the error path needs a machine without one")
    r = _launch("--arch", "minitron-4b", "--smoke", "--steps", "1", tmp_path=tmp_path)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
