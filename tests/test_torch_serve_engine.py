"""The port's ``ServeEngine`` (``repro_torch.serve.engine``) and its
launcher against the JAX package's, on the CPU.

Both engines serve the same requests on the same weights (JAX's
``init(PRNGKey(0))`` through numpy) in float32, where the logits agree
within 1e-4 (``tests/test_torch_models.py``), and must emit the same
greedy tokens.  Batch order: the port's ``order_by_length`` is
``np.argsort(lens, kind="stable")``; where no two lengths tie that is the
reference's order too, and on ties the reference's bitonic network may
swap equal lengths, so there only the sorted lengths are compared.
"""

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
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.launch.serve import synthetic_requests
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
SERVED = tuple(jregistry.ARCHS)  # all ten archs, every model family
FAMILIES = ("mamba2-370m", "zamba2-2.7b", "whisper-tiny", "qwen2-vl-7b")  # ssm, hybrid, encdec, vlm
# distinct prompt lengths, and a different token budget per request
LENS = (5, 17, 3, 11)
NEW = (6, 4, 6, 5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny: one torch thread a test process, so this file
    does not crowd the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch: str):
    jc = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32, remat=False)
    tc = registry.get_config(arch, smoke=True).replace(dtype=torch.float32)
    jp = jregistry.get_model_api(jc).init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _prompts(vocab: int, lens, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _engine(tc, tp, max_len: int = 64) -> ServeEngine:
    return ServeEngine(tc, tp, registry.get_model_api(tc), max_len=max_len, device="cpu")


@pytest.mark.parametrize("arch", SERVED)
def test_generate_matches_reference_f32(arch):
    jc, tc, jp, tp = _setup(arch)
    prompts = _prompts(jc.vocab_size, LENS)
    want = JServeEngine(jc, jp, jregistry.get_model_api(jc), max_len=64).generate(
        [JRequest(i, p, n) for i, (p, n) in enumerate(zip(prompts, NEW))]
    )
    got = _engine(tc, tp).generate([Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, NEW))])
    assert got == want
    assert [len(got[i]) for i in range(len(NEW))] == list(NEW)


def test_order_by_length_matches_reference_on_distinct_lengths():
    jc, tc, jp, tp = _setup("qwen1.5-32b")
    lens = (9, 2, 31, 7, 30, 4, 12, 1)
    prompts = _prompts(jc.vocab_size, lens)
    jeng = JServeEngine(jc, jp, jregistry.get_model_api(jc), max_len=64)
    want = [r.id for r in jeng.order_by_length([JRequest(i, p) for i, p in enumerate(prompts)])]
    got = [r.id for r in _engine(tc, tp).order_by_length([Request(i, p) for i, p in enumerate(prompts)])]
    assert got == want == list(np.argsort(lens, kind="stable"))


@pytest.mark.parametrize("seed", range(4))
def test_order_by_length_keeps_ties_in_arrival_order(seed):
    jc, tc, jp, tp = _setup("minitron-4b")
    lens = np.random.default_rng(seed).integers(1, 6, 24)
    prompts = _prompts(jc.vocab_size, lens, seed)
    got = [r.id for r in _engine(tc, tp).order_by_length([Request(i, p) for i, p in enumerate(prompts)])]
    assert got == list(np.argsort(lens, kind="stable"))
    jeng = JServeEngine(jc, jp, jregistry.get_model_api(jc), max_len=64)
    want = [r.id for r in jeng.order_by_length([JRequest(i, p) for i, p in enumerate(prompts)])]
    assert sorted(want) == list(range(len(lens))) and list(lens[want]) == list(lens[got])


@pytest.mark.parametrize("n", (4, 16))
def test_launcher_mix_orders_stably(n):
    """The chip run's request mix: 16 requests tie on five lengths."""
    _, tc, _, tp = _setup("deepseek-v2-lite-16b")
    reqs = synthetic_requests(n, tc.vocab_size, 16)
    lens = [len(r.prompt) for r in reqs]
    assert [r.id for r in _engine(tc, tp).order_by_length(reqs)] == list(np.argsort(lens, kind="stable"))


def test_empty_batch_and_single_request():
    _, tc, _, tp = _setup("gemma3-4b")
    eng = _engine(tc, tp)
    assert eng.generate([]) == {}
    one = Request(7, _prompts(tc.vocab_size, (6,))[0], 3)
    assert eng.order_by_length([one]) == [one]
    out = eng.generate([one])
    assert list(out) == [7] and len(out[7]) == 3


@pytest.mark.parametrize("arch", ("deepseek-v2-lite-16b", "mixtral-8x22b", "qwen1.5-110b") + FAMILIES)
def test_generate_counts_one_pair_sort_and_one_count_rank_a_moe_layer_a_step(arch, monkeypatch):
    _, tc, _, tp = _setup(arch)
    tc = tc.replace(dtype=torch.bfloat16)  # the served dtype
    calls = {"bcr": 0, "pairs": 0}
    bcr, pairs = ops.bucket_count_rank, ops.local_sort_pairs

    def count_bcr(*a, **kw):
        calls["bcr"] += 1
        return bcr(*a, **kw)

    def count_pairs(*a, **kw):
        calls["pairs"] += 1
        return pairs(*a, **kw)

    monkeypatch.setattr(ops, "bucket_count_rank", count_bcr)
    monkeypatch.setattr(ops, "local_sort_pairs", count_pairs)
    N = 5
    reqs = synthetic_requests(4, tc.vocab_size, N)
    out = _engine(tc, tp).generate(reqs)
    assert all(len(out[r.id]) == N for r in reqs)
    # one prefill and N - 1 decode steps, each through every layer
    assert calls == {"bcr": tc.num_layers * N if tc.is_moe else 0, "pairs": 1}


def test_generate_is_deterministic_in_bf16():
    _, tc, _, tp = _setup("deepseek-v2-lite-16b")
    eng = _engine(tc.replace(dtype=torch.bfloat16), tp)
    reqs = synthetic_requests(6, tc.vocab_size, 8)
    first = eng.generate(reqs)
    assert first == eng.generate(reqs)
    assert sorted(first) == list(range(6)) and all(len(v) == 8 for v in first.values())


class _CardSorter:
    device = torch.device("cuda")


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    _, tc, _, tp = _setup("minitron-4b")
    assert ServeEngine(tc, tp, lm, device="cpu").sorter.device.type == "cpu"
    with pytest.raises(ValueError, match="sorter"):
        ServeEngine(tc, tp, lm, device="cpu", sorter=_CardSorter())
    if torch.cuda.is_available():
        assert ServeEngine(tc, tp, lm).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(tc, tp, lm)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


@pytest.mark.parametrize("arch", ("deepseek-v2-lite-16b",) + FAMILIES)
def test_cli_serves_the_smoke_model_on_the_cpu(arch):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", "--new-tokens", "6"],
        env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"request {i}" for i in range(4)]
    assert all(": 6 tokens -> " in ln for ln in lines)


def test_cli_refuses_an_unported_family_and_a_missing_card():
    """Every arch of the registry is served now; an arch outside it is
    refused, and so is a missing card."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "rwkv-7b", "--smoke", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0 and "invalid choice: 'rwkv-7b'" in r.stderr
    if not torch.cuda.is_available():
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma3-4b", "--smoke"],
            env=_env(), capture_output=True, text=True, timeout=300,
        )
        assert r.returncode != 0 and "no CUDA device" in r.stderr
