"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import SortEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "tools" / "sort_variant_times.py",
    ROOT / "tools" / "mesh_fault_readings.py",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax_or_repro():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels, repro_torch.data, repro_torch.net\n"
        "import repro_torch.serve, repro_torch.serve.fleet.loadgen\n"
        "import repro_torch.verify, repro_torch.verify.__main__\n"
        "import repro_torch.configs.registry, repro_torch.models.lm, repro_torch.models.convert\n"
        "import repro_torch.models.ssm, repro_torch.models.encdec\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.train, repro_torch.optim, repro_torch.ckpt, repro_torch.launch.train\n"
        "import repro_torch.perf, repro_torch.perf.__main__, repro_torch.roofline, repro_torch.roofline.analysis\n"
        "import repro_torch.launch.mesh, repro_torch.launch.sharding, repro_torch.launch.dryrun, repro_torch.launch.diag\n"
        "import repro_torch.roofline.report, repro_torch.roofline.gen_experiments\n"
        "import repro_torch.core.dist_sort, repro_torch.core.sample_sort\n"
        "import repro_torch.runtime, repro_torch.runtime.ranks, repro_torch.runtime.collectives\n"
        "import repro_torch.runtime.elastic, repro_torch.runtime.pipeline\n"
        "import repro_torch.models.common, repro_torch.models.layers, repro_torch.models.mla, repro_torch.models.moe\n"
        "import repro_torch.train.loss, repro_torch.train.train_step, repro_torch.ckpt.checkpointer\n"
        "import repro_torch.optim.adamw, repro_torch.optim.compression\n"
        "from repro_torch.configs import registry\n"
        "for arch in registry.ARCHS: registry.get_model_api(registry.get_config(arch))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_the_dist_modules_are_checked():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES if "repro_torch" in p.parts}
    for mod in ("core/dist_sort.py", "core/sample_sort.py", "runtime/__init__.py", "runtime/ranks.py",
                "runtime/collectives.py", "runtime/elastic.py", "runtime/pipeline.py"):
        assert mod in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_engine_needs_a_card_unless_asked_for_the_cpu():
    assert SortEngine(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert SortEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SortEngine()


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the no-card failure shows only where there is no card")
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], env=_env(), capture_output=True, text=True, timeout=120
    )
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
