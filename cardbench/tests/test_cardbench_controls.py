"""Each cell's control comes out not correct, and a sound run correct.

On the CPU at the smoke sizes (``cardbench_smoke_root``), on three seeds:
the program's readings pass the smoke limits, and the reference computed
in the precision below the configuration's (fp8 matmul operands for a
bf16 model; float32 keys for int32 keys) fails one of them.  With a card,
``-m cuda`` runs the same at each cell's own size against the committed
limits (about a minute a seed for a training cell).
"""

from __future__ import annotations

import json

import pytest
import torch
from cardbench_smoke_root import REPO, smoke_root, workloads

from cardbench import run as harness

SEEDS = (3_000_000_101, 3_000_000_102, 3_000_000_103)


def _fails(numbers: dict, limits: dict) -> bool:
    """Whether a number with a limit exceeds it (numbers without one are
    read and printed by a run, not compared)."""
    return any(v > limits[k]["limit"] for k, v in numbers.items() if k in limits)


def _read(c, seed, device):
    harness.use_program(c["root"])
    return harness.load(c["driver"], "driver").readings(c, seed, True, False, device)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("controls"))


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_sound_passes(root, workload, seed):
    c = harness.cell(root, workload)
    out = _read(c, seed, torch.device("cpu"))
    assert not _fails(out["sound"], c["limits"]), out
    assert _fails(out["control"], c["limits"]), out


@pytest.mark.cuda
@pytest.mark.parametrize("workload", workloads())
def test_control_fails_at_the_cell(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = harness.cell(REPO, workload)
    for seed in SEEDS:
        out = _read(c, seed, torch.device("cuda"))
        print(json.dumps(out))
        assert not _fails(out["sound"], c["limits"]), out
        assert _fails(out["control"], c["limits"]), out
