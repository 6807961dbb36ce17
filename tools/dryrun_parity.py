"""The port's dry-run against the JAX package's, cell by cell.

    PYTHONPATH=src python tools/dryrun_parity.py smoke   # the ten smoke archs on (2, 2, 2)
    PYTHONPATH=src python tools/dryrun_parity.py flops   # full-width FLOPs against MODEL_FLOPS

``smoke``: the reference lowers and compiles every smoke arch's train,
prefill and decode cell (32 tokens, batch 8, layers unrolled so XLA counts
each) on 8 fake XLA devices as a (2, 2, 2) pod/data/model mesh, in a
subprocess; the port traces the same cells
(``repro_torch.launch.dryrun.predict``, no calibration).  Prints each
cell's port/reference ratio of FLOPs, bytes accessed, collective bytes and
temp, the argument-byte difference and both alias sizes, then each
ratio's range: the bands ``tests/test_torch_dryrun.py`` pins.

``flops``: one device's train step at 1 × 4,096 tokens of DeepSeek-V2-Lite
(2 layers), Qwen1.5-110B (2 layers) and Zamba2-2.7B (6 layers) at full
width, traced with remat on and off, against ``model_flops_for`` (6·N·D),
with the share of N that is the input embedding table (a lookup: no
FLOPs).  Shapes only: nothing is allocated at full size.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro import compat
from repro.configs import registry
from repro.configs.base import RunConfig, ShapeConfig
from repro.launch.dryrun import build_lowered
from repro.roofline.analysis import collective_bytes
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for arch in registry.ARCHS:
    cfg = registry.get_config(arch, smoke=True).replace(scan_layers=False)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", 32, 8, kind)
        run = RunConfig(model=cfg, shape=shape, grad_accum=2 if kind == "train" else 1, grad_accum_unroll=True)
        compiled = build_lowered(cfg, shape, mesh, run)[0].compile()
        ca, mem = compat.cost_analysis(compiled), compiled.memory_analysis()
        out[f"{arch}/{kind}"] = {
            "flops": float(ca.get("flops", 0.0)), "bytes": float(ca.get("bytes accessed", 0.0)),
            "argument_bytes": mem.argument_size_in_bytes, "alias_bytes": mem.alias_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "coll": collective_bytes(compiled.as_text(), num_devices=8, pod_block=4)["total"],
        }
print("RESULT " + json.dumps(out))
"""


def smoke() -> None:
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REFERENCE], env=env, capture_output=True, text=True, timeout=1800)
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    if r.returncode != 0 or not line:
        raise SystemExit(f"the reference's compile failed: {r.stderr[-3000:]}")
    ref = json.loads(line[0][len("RESULT "):])
    mesh = MeshSpec((2, 2, 2), ("pod", "data", "model"))
    ratios = {"flops": [], "bytes": [], "coll": [], "temp": []}
    print("cell | flops | bytes | collectives | temp | argument bytes port - reference | alias port / reference")
    for key, want in ref.items():
        arch, kind = key.split("/")
        rec = dryrun.predict(arch, registry.get_config(arch, smoke=True), ShapeConfig("t", 32, 8, kind), mesh,
                             grad_accum=2, calibrate=False)
        raw, mem = rec["raw_roofline_scanbody_once"], rec["memory_analysis"]
        got = {"flops": raw["flops_per_device"], "bytes": raw["bytes_per_device"],
               "coll": raw["collective_bytes"]["total"], "temp": mem["temp_bytes"]}
        for k in ratios:
            ratios[k].append(got[k] / (want[k if k != "temp" else "temp_bytes"] or 1))
        print(f"{key} | {ratios['flops'][-1]:.3f} | {ratios['bytes'][-1]:.3f} | {ratios['coll'][-1]:.3f} | "
              f"{ratios['temp'][-1]:.3f} | {mem['argument_bytes'] - want['argument_bytes']} | "
              f"{mem['alias_bytes']} / {want['alias_bytes']}")
    for k, v in ratios.items():
        print(f"{k}: {min(v):.3f}-{max(v):.3f} over {len(v)} cells")


def flops() -> None:
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.roofline.analysis import model_flops_for

    shape = ShapeConfig("train_4k", 4096, 1, "train")
    mesh = MeshSpec((1,), ("data",))
    for arch, layers in (("deepseek-v2-lite-16b", 2), ("qwen1.5-110b", 2), ("zamba2-2.7b", 6)):
        cfg = registry.get_config(arch).replace(num_layers=layers)
        mf = model_flops_for(cfg, shape)
        traced = {}
        for remat in (True, False):
            rec = dryrun.predict(arch, cfg.replace(remat=remat), shape, mesh, grad_accum=1, calibrate=False)
            traced[remat] = rec["raw_roofline_scanbody_once"]["flops_per_device"]
        emb = cfg.vocab_size * cfg.d_model
        print(f"{arch} {layers} layers, 1 x 4096: traced {traced[True]:.4e} FLOPs (remat), {traced[False]:.4e} "
              f"(no remat); 6·N·D {mf:.4e}; traced / 6·N·D {traced[True] / mf:.3f} (remat), "
              f"{traced[False] / mf:.3f} (no remat); the input embedding table is {emb / cfg.param_count():.3f} of N")


if __name__ == "__main__":
    {"smoke": smoke, "flops": flops}[sys.argv[1] if len(sys.argv) > 1 else "smoke"]()
