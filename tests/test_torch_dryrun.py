"""The dry-run and the roofline report over the port against the JAX
package's.

* The dry-run's algebra (``GRAD_ACCUM``, ``LEVERS``, ``_layer_period``,
  ``_scaled_cfg``, ``calibrated_costs`` with both ``_measure``s patched
  to the same canned numbers) equals the reference's exactly.
* A real compile of the reference (8 fake XLA devices in one subprocess,
  minitron-4b smoke on the (2, 2, 2) pod/data/model mesh, a train and a
  decode cell, layers unrolled so that XLA counts every one) against the
  port's trace of the same cells: argument and alias bytes to the byte,
  each difference stated; FLOPs and collective bytes within pinned bands.
* The report and the section generator give the reference's text on the
  same cell dicts, but for the documented fit column, paragraphs and
  lever sentences.
* The trace itself: K1 is one op that launches nothing; a shape-only
  state build matches the real one leaf for leaf; the CLIs run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.roofline import analysis as janalysis
from repro.roofline import gen_experiments as jgen
from repro.roofline import report as jreport
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import SHAPES, RunConfig, ShapeConfig
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MeshSpec, make_smoke_mesh
from repro_torch.models.common import tree_leaves
from repro_torch.roofline import analysis, gen_experiments, report
from repro_torch.roofline.hw import H100, V5E
from repro_torch.train.train_step import init_train_state

# The reference's dry-run sets XLA_FLAGS to 512 host devices when imported;
# jax reads the flag at its first backend use, so it is put back at once
# and this process keeps its one device.
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(tregistry.ARCHS)


def _env():
    """The subprocesses' environment: one thread each (the suite's other
    workers share the cores), no inherited XLA flags."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ================================================================== algebra
def _dtype_name(v) -> str:
    return str(v)[len("torch."):] if isinstance(v, torch.dtype) else np.dtype(v).name


def _fields(cfg) -> dict:
    """A config's fields, dtypes by name (torch's and jax's differ)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else (_dtype_name(v) if "dtype" in f.name else v)
    return out


def test_grad_accum_and_layer_helpers_equal_the_reference():
    assert D.GRAD_ACCUM == JD.GRAD_ACCUM
    for arch in ARCHS:
        tcfg, jcfg = tregistry.get_config(arch), jregistry.get_config(arch)
        assert D._layer_period(tcfg) == JD._layer_period(jcfg)
        for n in (1, 2, 6, 12):
            for scan in (False, True):
                assert _fields(D._scaled_cfg(tcfg, n, scan)) == _fields(JD._scaled_cfg(jcfg, n, scan))


@pytest.mark.parametrize("lever", list(JD.LEVERS))
def test_levers_equal_the_reference(lever):
    assert list(D.LEVERS) == list(JD.LEVERS)
    for arch in ARCHS:
        tcfg, tkw = D.LEVERS[lever](tregistry.get_config(arch), {"x": 1})
        jcfg, jkw = JD.LEVERS[lever](jregistry.get_config(arch), {"x": 1})
        assert _fields(tcfg) == _fields(jcfg) and tkw == jkw, arch


def _canned(cfg, shape, mesh, run, **_):
    """Costs that depend on the variant's depth, batch and microbatches."""
    L, B, A = cfg.num_layers, shape.global_batch, run.grad_accum
    return {
        "flops": 1e9 * (3 + 7 * L) * B + 5e8 * A,
        "bytes": 2e8 * (1 + 3 * L) + 1e7 * B * A,
        "coll_intra": 4e6 * L * A + 1e5 * B,
        "coll_inter": 3e5 * (L + 2) + 7e4 * A,
    }


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-v2-lite-16b", "whisper-tiny", "zamba2-2.7b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_calibrated_costs_equal_the_reference(monkeypatch, arch, shape):
    monkeypatch.setattr(D, "_measure", _canned)
    monkeypatch.setattr(JD, "_measure", _canned)
    for a_eff, run_kw in ((4, {}), (1, {"master_weights": True}), (2, {"_grad_specs": True})):
        got = D.calibrated_costs(arch, tregistry.get_config(arch), SHAPES[shape], None, a_eff=a_eff,
                                 run_kw=dict(run_kw))
        want = JD.calibrated_costs(arch, jregistry.get_config(arch), JD.SHAPES[shape], None, a_eff=a_eff,
                                   pod_block=None, run_kw=dict(run_kw))
        assert got == want


# ============================================== against the reference's compile
REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false"
from repro import compat
from repro.configs import registry
from repro.configs.base import RunConfig, ShapeConfig
from repro.launch.dryrun import build_lowered
from repro.roofline.analysis import collective_bytes, roofline_from_compiled
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = registry.get_config("minitron-4b", smoke=True).replace(scan_layers=False)
out = {}
for kind in ("train", "decode"):
    shape = ShapeConfig("t", 32, 8, kind)
    run = RunConfig(model=cfg, shape=shape, grad_accum=2 if kind == "train" else 1, grad_accum_unroll=True)
    compiled = build_lowered(cfg, shape, mesh, run)[0].compile()
    mem = compiled.memory_analysis()
    rec = roofline_from_compiled(compiled, num_devices=8, pod_block=4, model_flops=1.0)
    out[kind] = {
        "flops": rec["flops_per_device"],
        "argument_bytes": mem.argument_size_in_bytes,
        "alias_bytes": mem.alias_size_in_bytes,
        "coll": collective_bytes(compiled.as_text(), num_devices=8, pod_block=4),
        "keys": sorted(rec),
    }
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_cells():
    r = subprocess.run([sys.executable, "-c", REFERENCE], env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stderr[-3000:]
    return json.loads(line[0][len("RESULT "):])


@pytest.fixture(scope="module")
def port_cells():
    cfg = tregistry.get_config("minitron-4b", smoke=True)
    mesh = MeshSpec((2, 2, 2), ("pod", "data", "model"))
    return {
        kind: D.predict("minitron-4b", cfg, ShapeConfig("t", 32, 8, kind), mesh, grad_accum=2, calibrate=False)
        for kind in ("train", "decode")
    }


def test_argument_and_alias_bytes_against_the_reference(reference_cells, port_cells):
    # (2, 2, 2): each device holds 8 / 4 = 2 sequences of 32 tokens
    train, decode = port_cells["train"]["memory_analysis"], port_cells["decode"]["memory_analysis"]
    ref_train, ref_decode = reference_cells["train"], reference_cells["decode"]
    # the port's token ids and labels are int64, the reference's int32
    assert train["argument_bytes"] - ref_train["argument_bytes"] == 2 * (2 * 32 * 4)
    # the donated train state, byte for byte
    assert train["alias_bytes"] == ref_train["alias_bytes"] > 0
    # decode: an int64 token a sequence here, an int32 token and the int32
    # position there
    assert decode["argument_bytes"] - ref_decode["argument_bytes"] == 2 * 8 - (2 * 4 + 4)
    # the port's decode_step returns a new cache and leaves its argument as
    # it was, so nothing is donated; the reference donates the cache
    assert decode["alias_bytes"] == 0 < ref_decode["alias_bytes"]


# FlopCounterMode counts matmul FLOPs; XLA also counts elementwise work,
# which at the smoke configs' widths (d_model 64) is a large share.  The
# ten smoke archs' train, prefill and decode cells read 0.288-0.960
# (PERF.md); minitron's two cells 0.734 and 0.446.
FLOP_BAND = (0.25, 1.0)
# Collectives are derived from the specs, not read from HLO: 0.619-1.687
# of the reference's over the ten smoke archs; minitron's cells 1.022 and
# 1.343.
COLLECTIVE_BAND = (0.5, 2.0)


def test_flops_within_a_band_of_the_reference(reference_cells, port_cells):
    for kind in ("train", "decode"):
        ratio = port_cells[kind]["raw_roofline_scanbody_once"]["flops_per_device"] / reference_cells[kind]["flops"]
        assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], (kind, ratio)


def test_collectives_against_the_reference(reference_cells, port_cells):
    for kind in ("train", "decode"):
        got = port_cells[kind]["raw_roofline_scanbody_once"]["collective_bytes"]
        want = reference_cells[kind]["coll"]
        assert set(got) == set(want)
        assert COLLECTIVE_BAND[0] <= got["total"] / want["total"] <= COLLECTIVE_BAND[1], kind
        # both gather weights and all-reduce; XLA's CPU partitioner here
        # reduces FSDP gradients by all-reduce and moves shards by
        # collective-permute, where the port's view reduce-scatters them
        present = {k for k, v in want["by_kind"].items() if v}
        assert {"all-gather", "all-reduce"} <= present & set(got["by_kind"])
        assert got["halved"] == 0
    assert port_cells["train"]["raw_roofline_scanbody_once"]["collective_bytes"]["inter_pod"] > 0
    assert reference_cells["train"]["coll"]["inter_pod"] > 0
    one = D.predict("minitron-4b", tregistry.get_config("minitron-4b", smoke=True), ShapeConfig("t", 32, 2, "train"),
                    MeshSpec((1,), ("data",)), grad_accum=2, calibrate=False)
    assert one["raw_roofline_scanbody_once"]["collective_bytes"]["total"] == 0


def test_roofline_record_has_the_reference_keys(reference_cells, port_cells):
    tr = analysis.Trace(flops=2e12, bytes=3e9, peak_bytes=10, out_bytes=4, made_out_bytes=4, alias_bytes=0, ops=None)
    mem = analysis.memory_analysis(tr, argument_bytes=100)
    rec = analysis.roofline_from_trace(tr, analysis.collective_bytes([]), mem, num_devices=8, hw=V5E,
                                       model_flops=1.0)
    assert sorted(rec) == reference_cells["train"]["keys"]
    for k in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "total_bytes"):
        assert k in port_cells["train"]["memory_analysis"]


# ============================================================ the arithmetic
def test_collective_bytes_sums_records():
    C = analysis.Collective
    got = analysis.collective_bytes([
        C("all-gather", ("data",), 100, 3), C("all-reduce", ("pod",), 7), C("all-reduce", ("pod", "data"), 5, 2),
        C("reduce-scatter", ("data", "model"), 11),
    ])
    assert got == {"total": 328, "intra_pod": 311, "inter_pod": 17, "count": 7, "halved": 0,
                   "by_kind": {"all-gather": 300, "all-reduce": 17, "reduce-scatter": 11}}
    with pytest.raises(ValueError, match="kind"):
        analysis.collective_bytes([C("broadcast", ("data",), 1)])


def test_param_shape_set_equals_the_reference():
    import jax

    for arch in ("deepseek-v2-lite-16b", "zamba2-2.7b"):
        tcfg, jcfg = tregistry.get_config(arch, smoke=True), jregistry.get_config(arch, smoke=True)
        tshape = D.eval_shape(tregistry.get_model_api(tcfg).init, tcfg, torch.Generator())
        jshape = jax.eval_shape(lambda: jregistry.get_model_api(jcfg).init(jax.random.PRNGKey(0), jcfg))
        want = janalysis.param_shape_set(jshape)
        assert analysis.param_shape_set(tshape) == want
        assert analysis.param_shape_set([tuple(t.shape) for t in tree_leaves(tshape)]) == want


# ================================================================ the trace
def test_a_traced_moe_cell_launches_nothing_and_counts_k1_once_a_call():
    """K1's wrapper is one op (``repro_torch::bucket_count_rank``) with 0
    FLOPs: a forward and a remat recompute a layer, no launch, none of the
    plain version's ops."""
    cfg = tregistry.get_config("deepseek-v2-lite-16b", smoke=True)
    shape = ShapeConfig("t", 32, 2, "train")
    traced, _ = D.build_traced(cfg, shape, make_smoke_mesh(1), RunConfig(model=cfg, shape=shape))
    reset_launches()
    tr, _ = D.run_traced(traced, keep_ops=True)
    assert launch_counts()["bucket_count_rank"] == 0
    ops = [r.op for r in tr.ops]
    assert ops.count("repro_torch.bucket_count_rank.default") == 2 * cfg.num_layers
    assert "aten.cumsum.default" not in ops
    assert tr.flops > 0 and tr.peak_bytes > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_only_state_matches_the_real_one(arch):
    cfg = tregistry.get_config(arch, smoke=True)
    api = tregistry.get_model_api(cfg)
    for run in (RunConfig(model=cfg), RunConfig(model=cfg, master_weights=True, grad_compression="int8")):
        meta = D.eval_shape(init_train_state, torch.Generator(), cfg, run, api)
        real = init_train_state(torch.Generator().manual_seed(0), cfg, run, api)
        assert len(tree_leaves(meta)) == len(tree_leaves(real))
        for m, r in zip(tree_leaves(meta), tree_leaves(real)):
            assert m.device.type == "meta" and (m.shape, m.dtype) == (r.shape, r.dtype)


def test_one_device_train_memory_is_the_state_plus_the_step():
    """On one device nothing is sharded: the arguments are the state and
    the batch, the state comes back in place (aliased), and the memory
    extrapolated from the variants equals a full-depth trace's."""
    cfg = tregistry.get_config("minitron-4b", smoke=True)
    shape = ShapeConfig("t", 64, 2, "train")
    mesh = make_smoke_mesh(1)
    full = D.predict("minitron-4b", cfg, shape, mesh, grad_accum=1, full_trace=True)
    extra = D.predict("minitron-4b", cfg, shape, mesh, grad_accum=1)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, RunConfig(model=cfg), tregistry.get_model_api(cfg))
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    mem = full["memory_analysis"]
    assert mem["argument_bytes"] == state_bytes + 2 * 2 * 64 * 8
    assert mem["alias_bytes"] == state_bytes and mem["gathered_gradient_bytes"] == 0
    assert extra["memory_analysis"] == mem
    assert full["roofline"]["calibration"]["memory"] == "traced at full depth"
    assert extra["roofline"]["calibration"]["memory"] == "extrapolated from the variants"
    assert full["roofline"]["flops_per_device"] == pytest.approx(full["raw_roofline_scanbody_once"]["flops_per_device"])


def test_sequence_parallel_trace_gathers_kv():
    """Under SP each device traces its sequence slice against K/V gathered
    to the whole sequence: the same FLOPs as a batch split, less the
    per-device work's share of nothing."""
    cfg = tregistry.get_config("qwen1.5-32b", smoke=True).replace(num_heads=6, num_kv_heads=6, head_dim=16)
    shape = ShapeConfig("t", 64, 4, "prefill")
    sp = D.predict("qwen1.5-32b", cfg, shape, MeshSpec((1, 4), ("data", "model")), calibrate=False)
    assert sp["rules"]["seq"] == "model"
    whole = D.predict("qwen1.5-32b", cfg, shape, MeshSpec((1,), ("data",)), calibrate=False)
    assert sp["raw_roofline_scanbody_once"]["flops_per_device"] == pytest.approx(
        whole["raw_roofline_scanbody_once"]["flops_per_device"] / 4, rel=0.05)
    kinds = sp["raw_roofline_scanbody_once"]["collective_bytes"]["by_kind"]
    assert kinds["all-gather"] > 0


@pytest.mark.parametrize(
    "arch, mesh, batch",
    [
        ("qwen1.5-110b", ((1, 4), ("data", "model")), 2),  # 4 query heads divide the model axis, 2 KV heads do not
        ("mixtral-8x22b", ((2, 2), ("data", "model")), 1),  # a ring cache split on its sequence
    ],
)
def test_decode_views_cohere(arch, mesh, batch):
    """GQA groups stay whole where the KV heads do not divide the model
    axis (the rules shard no head), and a ring cache whose length is the
    window's is gathered over the cache's sequence axes."""
    cfg = tregistry.get_config(arch, smoke=True)
    rec = D.predict(arch, cfg, ShapeConfig("t", 64, batch, "decode"), MeshSpec(*mesh), calibrate=False)
    assert rec["raw_roofline_scanbody_once"]["flops_per_device"] > 0
    assert rec["memory_analysis"]["argument_bytes"] > 0


# ================================================================== report
def _cells():
    out = []
    for i, (arch, shape) in enumerate(tregistry.supported_cells()[:9]):
        for mesh in ("single", "multi"):
            dom = ("compute", "memory", "collective")[i % 3]
            out.append({
                "arch": arch, "shape": shape, "mesh": mesh, "compile_s": 1.5 + i, "grad_accum": 1 + i % 4,
                "rules": {"batch": ["data"], "heads": "tp", "seq": None, "kv_seq": None},
                "memory_analysis": {"total_bytes": (3 + 9 * i) * 1e9},
                "roofline": {
                    "t_compute_s": 0.1 * (i + 1), "t_memory_s": 0.2 + i, "t_collective_s": 0.05 * i,
                    "dominant": dom, "bound_time_s": 0.2 + i, "useful_flops_ratio": 0.5 + i / 20,
                    "roofline_fraction": 0.1 / (i + 1), "coll_intra_bytes": 1e9 * i,
                    "coll_inter_bytes": 2e9 * (i % 2),
                },
                "levers": ["bf16mm"] if i % 2 else [],
            })
    return out


def _table(text):
    return [ln for ln in text.splitlines() if ln.startswith("| ") and not ln.startswith("| arch")]


def test_report_equals_the_reference():
    cells = _cells()
    for mesh in ("single", "multi"):
        got = report.markdown_table(cells, mesh, V5E).splitlines()
        want = jreport.markdown_table(cells, mesh).splitlines()
        # the fit column compares with the record's memory and names it
        assert got[0] == want[0].replace("fits 16G", "fits 16G (tpu-v5e)")
        assert got[1:] == want[1:]
        h100 = report.markdown_table(cells, mesh, H100)
        assert "fits 80G (nvidia-h100-sxm5-80gb)" in h100 and h100.count("| NO |") < got.count("| NO |") + 1
    assert report.pick_hillclimb(cells) == jreport.pick_hillclimb(cells)
    # the record comes from the cells: the H100's where they name none
    assert report.record_of(cells) is H100 and report.record_of([{"hw": V5E.name}]) is V5E
    with pytest.raises(ValueError, match="different records"):
        report.record_of([{"hw": V5E.name}, {"hw": H100.name}])


def test_sections_equal_the_reference_but_the_documented_text():
    cells = _cells()
    base = [c for c in cells if not c["levers"]]
    assert _table(gen_experiments.dryrun_section(base)) == _table(jgen.dryrun_section(base))
    got, want = _table(gen_experiments.roofline_section(base, V5E)), _table(jgen.roofline_section(base))
    # every column but the last (the lever sentence, in the H100's units)
    assert [ln.rsplit(" | ", 1)[0] for ln in got] == [ln.rsplit(" | ", 1)[0] for ln in want]
    tagged = [c for c in cells if c["levers"]]
    assert gen_experiments.variants_section(tagged) == jgen.variants_section(tagged)
    # the KV-streaming sentence names no unit; every other one names the H100's
    for c in cells:
        kv = c["roofline"]["dominant"] == "memory" and ("decode" in c["shape"] or "500k" in c["shape"])
        assert (gen_experiments.one_sentence(c) == jgen.one_sentence(c)) == kv


def test_cli_dryrun_report_and_gen_experiments(tmp_path):
    out = tmp_path / "cells"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "minitron-4b", "--shape", "decode_32k",
         "--mesh", "both", "--out", str(out), "--smoke"],
        env=_env(), cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert '"bucket_count_rank": 0' in r.stdout
    files = sorted(p.name for p in out.iterdir())
    assert files == ["minitron-4b__decode_32k__multi.json", "minitron-4b__decode_32k__single.json"]
    rec = json.loads((out / files[1]).read_text())
    assert rec["hw"] == H100.name and rec["devices"] == 256 and rec["roofline"]["bound_time_s"] > 0
    for mod in ("repro_torch.roofline.report", "repro_torch.roofline.gen_experiments"):
        r = subprocess.run([sys.executable, "-m", mod, "--dir", str(out)], env=_env(), cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0 and "minitron-4b" in r.stdout, r.stderr[-2000:]
