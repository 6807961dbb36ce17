"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process, one card.  Set-up (imports,
the card's start, the inputs and weights from the seed, the warm-up of
every shape the cell uses) runs from the process's start to the first
timed call and is ``setup_s``.  The window then calls the system back to
back until ``--seconds`` have passed, and closes when the last call
returns.  With ``--trace 1`` the first ``trace_calls`` calls of the window
(from the traffic file) run under the profiler and the per-layer metrics
are read from them.  Once the window has closed the peak memory is read,
the system's state is freed and the plain reference decides ``correct``.

The last line of standard output is one JSON object; the last lines of
standard error are the compared numbers beside their limits.  Without a
card, or with fewer cards than the cell asks for, or with JAX loaded at
the end, the run exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def load(path: Path, tag: str):
    """The module in ``path``, imported under a name of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"cardbench_{tag}_{path.stem.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: Path, workload: str) -> dict:
    """Everything one cell is made of, found by name under ``root``."""
    bench = read_json(root / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = read_json(root / entry["file"])
    traffic = read_json(root / "cardbench" / "traffic" / f"{wl['traffic']}.json")
    limits = read_json(root / "cardbench" / "limits" / f"{workload}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])

    return {
        "root": root, "workload": wl, "config": config, "traffic": traffic, "limits": limits,
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
        "driver": root / "cardbench" / "drivers" / f"{traffic['kind']}.py",
        "reference": root / "cardbench" / "reference" / f"{config['family']}.py",
    }


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


class Spans:
    """Host-clock spans of the call in progress: ``with spans("plan"): ...``."""

    def __init__(self):
        self.open: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.open.append((name, t0, time.perf_counter()))


def use_program(root: Path) -> None:
    """Put the port (``src/`` of the checkout) on the import path."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    os.environ.setdefault("USE_FLAX", "0")


def run(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float = T_START) -> dict:
    """One run of the cell ``c`` (from :func:`cell`) on ``device``."""
    import torch

    from cardbench import devtrace, hw

    use_program(c["root"])
    on_card = device.type == "cuda"
    traffic = c["traffic"]
    reference = load(c["reference"], "reference")
    driver = load(c["driver"], "driver")
    marks = [("imports", time.perf_counter())]
    if on_card:
        torch.ones(1, device=device).sum().item()  # the card's context, apart from the cell's own set-up
        marks.append(("card", time.perf_counter()))
    sut = driver.Cell(c["config"], traffic, seed, device, reference)
    marks.append(("inputs", time.perf_counter()))
    sut.warm()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    from repro_torch.kernels import launch_counts

    launches0 = launch_counts()
    n_trace = traffic["trace_calls"] if trace else 0
    calls, traced, failed = [], [], 0
    session = devtrace.Session() if n_trace and on_card else None
    spans = Spans()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", time.perf_counter()))
    print("set-up: " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b) in zip([("start", t_start)] + marks, marks)),
          file=sys.stderr, flush=True)
    t_w0 = time.perf_counter()
    deadline = t_w0 + seconds
    i = 0
    while i == 0 or time.perf_counter() < deadline:
        spans.open = []
        tracing = i < n_trace
        if tracing and session is not None and i == 0:
            session.__enter__()
        t0 = time.perf_counter()
        try:
            if tracing and session is not None:
                work = session.call(lambda: sut.call(i, True, spans))
            else:
                work = sut.call(i, tracing, spans)
        except Exception:  # a failed call counts against the run, which goes on
            print(f"call {i} failed:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
            failed += 1
            work = 0
        t1 = time.perf_counter()
        calls.append((t0, t1, work))
        if tracing:
            traced.append({"work": work, "wall_ms": (t1 - t0) * 1e3,
                           "spans": [(n, (a - t0) * 1e3, (b - t0) * 1e3) for n, a, b in spans.open]})
            if session is not None and i == n_trace - 1:
                session.__exit__(None, None, None)
        i += 1
    window_s = calls[-1][1] - t_w0
    if session is not None and len(traced) < n_trace:
        session.__exit__(None, None, None)
    launches = {k: v - launches0[k] for k, v in launch_counts().items() if v - launches0[k]}
    print(f"window: {len(calls)} calls in {window_s:.6f} s; kernel launches {launches}", file=sys.stderr, flush=True)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    peak = max(setup_peak, window_peak) if on_card else 0
    events = session.events() if session is not None else None
    if events is not None:
        for rec, ev in zip(traced, events):
            rec["events"] = ev
    sut.close()
    t_check = time.perf_counter()
    checks = sut.check()
    print(f"reference and check: {time.perf_counter() - t_check:.3f} s", file=sys.stderr, flush=True)
    ctx = {
        "setup_s": setup_s, "window_s": window_s, "calls": calls, "traced": traced, "n_traced": len(traced),
        "config": c["config"], "traffic": traffic, "window_peak_bytes": window_peak,
        "hw": hw,
    }
    busy_s = trace_window_s = None
    if events is not None:
        busy_s, trace_window_s = busy(traced)
        ctx.update(busy_s=busy_s, trace_window_s=trace_window_s)
    wanted = c["per_layer"] if trace else c["end_to_end"]
    metrics = {}
    for m in wanted:
        value = load(c["root"] / "cardbench" / "metrics" / f"{m['name']}.py", "metric").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lines = {}
    correct = failed == 0
    for name, value in checks.items():
        if name not in c["limits"]:  # read, but with no limit its readings could set
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr, flush=True)
            continue
        limit = c["limits"][name]["limit"]
        lines[name] = {"value": value, "limit": limit}
        correct = correct and value <= limit
    if set(c["limits"]) - set(checks):
        raise KeyError(f"the check read no {sorted(set(c['limits']) - set(checks))}")
    result = {
        "correct": correct, "attempted": len(calls), "failed": failed, "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card else device.type,
            "count": c["workload"]["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if trace and busy_s is not None:
        result["device"].update(busy_s=busy_s, window_s=trace_window_s)
        result["breakdown"] = breakdown(traced)
    result["checks"] = lines
    return result


def busy(traced: list) -> tuple[float, float]:
    """Seconds in which a device operation ran (the union of the traced
    calls' events) and the traced calls' wall seconds."""
    busy_ms = 0.0
    for rec in traced:
        end = float("-inf")
        for _, start, ms in sorted(rec.get("events", []), key=lambda e: e[1]):
            a, b = max(start, end), start + ms
            if b > a:
                busy_ms += b - a
            end = max(end, b)
    return busy_ms / 1e3, sum(r["wall_ms"] for r in traced) / 1e3


def breakdown(traced: list) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the card labelled by the benchmark's span open at the
    time (``python`` where none was)."""
    by_name: dict = {}
    gaps = []
    for rec in traced:
        evs = sorted(rec.get("events", []), key=lambda e: e[1])
        for name, _, ms in evs:
            by_name[name] = by_name.get(name, 0.0) + ms / 1e3
        end = 0.0
        for _, s, ms in evs + [("end", rec["wall_ms"], 0.0)]:
            if s > end:
                mid = (s + end) / 2
                label = next((n for n, a, b in rec["spans"] if a <= mid <= b), "python")
                gaps.append([label, (s - end) / 1e3])
            end = max(end, s + ms)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = cell(ROOT, args.workload)
    import torch

    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}", file=sys.stderr, flush=True)
    result = run(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the port's benchmark may load none of {FORBIDDEN}", file=sys.stderr)
        return 3
    for name, line in result["checks"].items():
        print(f"check {name} {line['value']!r} limit {line['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
