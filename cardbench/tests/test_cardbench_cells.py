"""Every cell end to end on the CPU at a smoke size, through the kernels'
plain versions; the faults each cell can have turn ``correct`` false; a
new configuration, mix and metric need only new files and entries."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
from cardbench_smoke_root import run_cell, smoke_root, workloads

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("cardbench"))


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_cell_runs(root, workload, trace):
    res = run_cell(root, workload, trace=trace)
    assert list(res) == KEYS  # no card, so no busy_s, window_s or breakdown
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    bench = json.loads((root / "BENCHMARK.json").read_text())
    kind = bench["per_layer"] if trace else bench["end_to_end"]
    want = {m["name"] for m in kind if workload in m.get("workloads", [workload])}
    got = set(res["metrics"])
    # the device readers find nothing to read on the CPU and stay silent
    assert got <= want
    if not trace:
        assert got == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    json.dumps(res)  # the line is JSON


def test_sort_answer_altered(root, monkeypatch):
    from repro_torch.core import engine

    sort = engine.SortEngine.sort

    def altered(self, x, **kw):
        y = sort(self, x, **kw)
        y[7] = y[8]
        return y

    monkeypatch.setattr(engine.SortEngine, "sort", altered)
    res = run_cell(root, "sort.ohhc-dh1.random-60mb")
    assert not res["correct"] and res["checks"]["mismatched_keys"]["value"] >= 1


def test_sort_half_the_keys_left_out(root, monkeypatch):
    from repro_torch.core import engine

    sort = engine.SortEngine.sort
    monkeypatch.setattr(engine.SortEngine, "sort", lambda self, x, **kw: sort(self, x[: x.size // 2], **kw))
    assert not run_cell(root, "sort.ohhc-dh1.random-60mb")["correct"]


TRAIN = [w for w in workloads() if w.startswith("train.")]


@pytest.mark.parametrize("workload", TRAIN)
def test_train_state_unchanged(root, workload, monkeypatch):
    from repro_torch.train import train_step

    monkeypatch.setattr(train_step, "adamw_update", lambda params, grads, state, lr, cfg: {
        "grad_norm": lr * 0 + 1.0, "clip_scale": lr * 0 + 1.0})
    res = run_cell(root, workload)
    assert not res["correct"] and res["checks"]["change_gap"]["value"] == 1.0


@pytest.mark.parametrize("workload", TRAIN)
def test_train_half_the_batch(root, workload, monkeypatch):
    from repro_torch.models import lm

    forward = lm.forward

    def half(params, batch, cfg, rules=None):
        B, S = batch["tokens"].shape
        cut = {k: (v[: B // 2] if B > 1 else v[:, : S // 2]) for k, v in batch.items()}
        return forward(params, cut, cfg) if rules is None else forward(params, cut, cfg, rules)

    monkeypatch.setattr(lm, "forward", half)
    from repro_torch.train import loss as loss_mod

    lm_loss = loss_mod.lm_loss
    from repro_torch.train import train_step

    def cut_loss(logits, labels, **kw):
        return lm_loss(logits, labels[: logits.shape[0], : logits.shape[1]], **kw)

    monkeypatch.setattr(train_step, "lm_loss", cut_loss)
    res = run_cell(root, workload)
    assert not res["correct"] and res["checks"]["grad_gap"]["value"] > res["checks"]["grad_gap"]["limit"]


def test_sort_control_is_not_correct(root, monkeypatch):
    """The reference's control (keys sorted as float32) in the program's
    place fails the check."""
    import cardbench.reference.ohhc_sort as ref
    from repro_torch.core import engine

    monkeypatch.setattr(engine.SortEngine, "sort", lambda self, x, **kw: ref.control(np.asarray(x)))
    res = run_cell(root, "sort.ohhc-dh1.random-60mb")
    assert not res["correct"] and res["checks"]["mismatched_keys"]["value"] > 1000


def test_new_cell_from_files_only(tmp_path):
    """A configuration, a mix, a per-layer metric and a cell, each added as
    new files and new entries, with no existing file edited."""
    root = smoke_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "cardbench").rglob("*") if p.is_file()}
    cb = root / "cardbench"
    cfg = json.loads((cb / "configs" / "ohhc-dh1-int32.json").read_text())
    cfg.update(name="ohhc-dh2-int32", d_h=2, processors=144)
    (cb / "configs" / "ohhc-dh2-int32.json").write_text(json.dumps(cfg))
    (cb / "traffic" / "sorted-small.json").write_text(json.dumps(
        {"kind": "sort", "dists": ["sorted", "reversed"], "keys": 70_000, "dtype": "int32", "pool": 2,
         "check_every": 2, "trace_calls": 2}))
    (cb / "metrics" / "sort.p50_ms.py").write_text(
        "from cardbench.readers import tail_ms\n\n\ndef read(ctx):\n    return tail_ms(ctx, 50)\n")
    (cb / "limits" / "sort.ohhc-dh2.sorted-small.json").write_text(json.dumps({"mismatched_keys": {"limit": 0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ohhc-dh2-int32", "source": "the paper, OHHC d_h = 2",
                             "file": "cardbench/configs/ohhc-dh2-int32.json", "reduced": [], "why": "P = 144"})
    bench["workloads"].append({"name": "sort.ohhc-dh2.sorted-small", "config": "ohhc-dh2-int32",
                               "traffic": "sorted-small", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "sort.ohhc-dh1.random-60mb" in m.get("workloads", []):
            m["workloads"].append("sort.ohhc-dh2.sorted-small")
    bench["per_layer"].append({"name": "sort.p50_ms", "unit": "ms", "better": "lower", "source": "host_clock",
                               "layer": "planner", "moves": "sort_keys_per_s", "workloads": ["sort.ohhc-dh2.sorted-small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    res = run_cell(root, "sort.ohhc-dh2.sorted-small")
    assert res["correct"] and {"sort_keys_per_s", "setup_s"} == set(res["metrics"])
    res = run_cell(root, "sort.ohhc-dh2.sorted-small", trace=True, seconds=2.0)  # calls enough for a tail
    assert res["correct"] and res["metrics"]["sort.p50_ms"]["value"] > 0
    shutil.rmtree(root)
