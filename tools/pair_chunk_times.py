"""Time the pair sort (K5, K7) at several chunk sizes through its wrappers.

    python3 tools/pair_chunk_times.py [--log-chunks 11,12] [--rounds 6]

``csrc/bitonic.cu`` fixes the pairs one block holds (``kLogPairChunk``).
This script copies ``csrc/`` once for each value asked for, with that
constant rewritten, builds the copies (one nvcc each, all at once, into
``build/repro_torch/chunk<L>/``) and times each through the wrappers a
caller uses, ``bitonic.sort_pairs_tile_tagged`` and
``bitonic.sort_pairs_tile``.  Each variant is first held bit for bit
against the plain version.  A time is the median over calls of CUDA events
around one wrapper call (its host work included); the variants take turns
round by round (A B, then B A, ...), so drift falls on all alike.  The
device time of one call (``torch.profiler``, every launch summed) and its
launch count are printed beside it.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, bitonic  # noqa: E402

CHUNK_LINE = re.compile(r"constexpr int kLogPairChunk = \d+;")


def build(log_chunks) -> dict[int, ctypes.CDLL]:
    procs = {}
    for log_c in log_chunks:
        out = _build.BUILD_DIR / f"chunk{log_c}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_build.CSRC, out / "csrc")
        src = out / "csrc" / "bitonic.cu"
        text, found = CHUNK_LINE.subn(f"constexpr int kLogPairChunk = {log_c};", src.read_text())
        if found != 1:
            sys.exit(f"pair_chunk_times.py: bitonic.cu defines kLogPairChunk {found} times, expected once")
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / "bitonic.so"), str(src)]
        procs[log_c] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for log_c, proc in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"pair_chunk_times.py: nvcc failed for chunk 2^{log_c}:\n{output[-4000:]}")
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"chunk{log_c}" / "bitonic.so"))
        for fn, argtypes in _build._SIGNATURES["bitonic"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        libs[log_c] = lib
    return libs


def event_ms(fn, reps: int) -> list[float]:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def device_ms(fn, traces: int = 5) -> tuple[float, int]:
    """Device time and launch count of one call, from torch.profiler (one
    trace a call, median over ``traces`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        calls.append([e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA and "pair_" in e.name])
    return float(np.median([sum(c) for c in calls])) / 1e3, max(len(c) for c in calls)


def cases(dev, gen):
    """(label, call, plain call) for each request timed."""
    n = 1 << 19
    k = torch.from_numpy(gen.integers(-(2**31), 2**31, (1, n)).astype(np.int32)).to(dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)[None]
    tags = torch.zeros((1, n), dtype=torch.uint8, device=dev)
    flags = torch.from_numpy(gen.random((1, n)) < 0.5).to(dev)
    k64 = torch.from_numpy(gen.integers(-(2**62), 2**62, (2, 1 << 15))).to(dev)
    v64 = torch.from_numpy(gen.standard_normal((2, 1 << 15))).to(dev)
    t64 = torch.from_numpy(gen.random((2, 1 << 15)) < 0.3).to(dev)
    return [
        ("K5 (1, 2^19) int32/int32", lambda: bitonic.sort_pairs_tile_tagged(k, tags, idx),
         lambda: bitonic.sort_pairs_tile_tagged_plain(k, tags, idx)),
        ("K7 (1, 2^19) int32/int32", lambda: bitonic.sort_pairs_tile(k, idx),
         lambda: bitonic.sort_pairs_tile_plain(k, idx)),
        ("K5 (1, 2^19) int32/bool", lambda: bitonic.sort_pairs_tile_tagged(k, tags, flags),
         lambda: bitonic.sort_pairs_tile_tagged_plain(k, tags, flags)),
        ("K5 (2, 2^15) int64/float64", lambda: bitonic.sort_pairs_tile_tagged(k64, t64, v64),
         lambda: bitonic.sort_pairs_tile_tagged_plain(k64, t64, v64)),
    ]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-chunks", default="11,12", help="comma-separated log2 chunk sizes")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=21, help="calls timed a round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pair_chunk_times.py: no CUDA device")
    log_chunks = [int(c) for c in args.log_chunks.split(",")]
    libs = build(log_chunks)
    dev = torch.device("cuda")
    todo = cases(dev, np.random.default_rng(0))
    times = {(c, label): [] for c in log_chunks for label, _, _ in todo}
    for log_c in log_chunks:
        _build._libs["bitonic"] = libs[log_c]
        for label, fn, plain in todo:
            got, want = fn(), plain()
            bits = bitonic._BITS[got[1].element_size()]
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1].view(bits), want[1].view(bits))):
                sys.exit(f"pair_chunk_times.py: chunk 2^{log_c} {label} differs from the plain version")
    for rnd in range(args.rounds):
        order = log_chunks if rnd % 2 == 0 else log_chunks[::-1]
        for log_c in order:
            _build._libs["bitonic"] = libs[log_c]
            for label, fn, _ in todo:
                fn()
                times[log_c, label] += event_ms(fn, args.reps)
    for label, fn, _ in todo:
        for log_c in log_chunks:
            _build._libs["bitonic"] = libs[log_c]
            dev_ms, launches = device_ms(fn)
            print(
                f"chunk {1 << log_c:5d} {label}: {np.median(times[log_c, label]):.4f} ms by events "
                f"(median of {len(times[log_c, label])}), {dev_ms:.4f} ms on the card, {launches} launches",
                flush=True,
            )
    _build._libs.pop("bitonic")


if __name__ == "__main__":
    main()
