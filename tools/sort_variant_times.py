"""Time the tile sort (K2) or the pair sort (K5, K7) built with other constants.

    python3 tools/sort_variant_times.py tile "kLogKeyE=4" "kLogKeyE=3"
    python3 tools/sort_variant_times.py tile "kLogKeyChunkBytes=15" "kLogKeyChunkBytes=16"
    python3 tools/sort_variant_times.py pairs "kLogPairChunk=11" "kLogPairChunk=12"
        [--rounds 6] [--reps 21]

``csrc/bitonic.cu`` fixes each sort's tiers with plain constants: the keys
a thread holds (``kLogKeyE``) and the bytes a block holds
(``kLogKeyChunkBytes``) for K2, the pairs a block holds
(``kLogPairChunk``) for K5 and K7.  Each variant is a list of
``NAME=VALUE`` settings; this script copies ``csrc/`` once for each, with
those constants rewritten, builds the copies (one nvcc each, all at once,
into ``build/repro_torch/variant<i>/``) and times each through the
wrappers a caller uses (``bitonic.sort_tile``, or
``bitonic.sort_pairs_tile_tagged`` and ``bitonic.sort_pairs_tile``).  Each
variant is first held bit for bit against the plain version.  A time is
the median over calls of CUDA events around one wrapper call (its host
work included); the variants take turns round by round (A B, then B A,
...), so drift falls on all alike.  The device time of one call
(``torch.profiler``, every launch of the sort summed) and its launch count
are printed beside it.  Needs a CUDA card and nvcc.
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

from repro_torch import devtrace  # noqa: E402
from repro_torch.kernels import _build, bitonic  # noqa: E402

# The kernel names of each sort's launches, for the profiler.
KERNEL_PREFIX = {"tile": "key_", "pairs": "pair_"}


def parse_variant(text: str) -> dict[str, int]:
    settings = {}
    for item in text.split():
        name, _, value = item.partition("=")
        if not name.isidentifier() or not value.lstrip("-").isdigit():
            sys.exit(f"sort_variant_times.py: {item!r} is not NAME=INTEGER")
        settings[name] = int(value)
    return settings


def build(variants: list[dict[str, int]]) -> list[ctypes.CDLL]:
    procs = []
    for i, settings in enumerate(variants):
        out = _build.BUILD_DIR / f"variant{i}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_build.CSRC, out / "csrc")
        src = out / "csrc" / "bitonic.cu"
        text = src.read_text()
        for name, value in settings.items():
            text, found = re.subn(rf"constexpr int {name} = -?\d+;", f"constexpr int {name} = {value};", text)
            if found != 1:
                sys.exit(f"sort_variant_times.py: bitonic.cu defines {name} {found} times, expected once")
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / "bitonic.so"), str(src)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for i, proc in enumerate(procs):
        output, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"sort_variant_times.py: nvcc failed for variant {variants[i]}:\n{output[-4000:]}")
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", output)) - {"0"})
        print(f"variant {i} {variants[i]}: built, spill stores {spills or 'none'}", flush=True)
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"variant{i}" / "bitonic.so"))
        for fn, argtypes in _build._SIGNATURES["bitonic"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        libs.append(lib)
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


def device_ms(fn, prefix: str, traces: int = 5) -> tuple[float, int]:
    """Device time and launch count of one call, from torch.profiler (the
    median over ``traces`` calls traced in one session)."""
    calls = devtrace.call_events(fn, traces) or [[]]
    calls = [[ms for name, ms in c if prefix in name] for c in calls]
    return float(np.median([sum(c) for c in calls])), max(len(c) for c in calls)


def bits(t: torch.Tensor) -> torch.Tensor:
    """Integer view of keys or payloads, so equality is bit for bit."""
    return t.view(bitonic._BITS[t.element_size()]) if t.is_floating_point() else t


def tile_cases(dev, gen):
    """(label, call, plain call) for K2 at the main path's shapes and at
    one shape for each other key width."""
    def keys(shape, dtype):
        info = np.iinfo(dtype)
        return torch.from_numpy(gen.integers(info.min, info.max, shape, dtype=np.int64, endpoint=True).astype(dtype)).to(dev)

    cases = []
    for shape, dtype in (((72, 1 << 19), np.int32), ((36, 1 << 20), np.int32), ((2304, 4096), np.int32),
                         ((36, 1 << 18), np.int64), ((36, 1 << 18), np.int16), ((36, 1 << 18), np.int8)):
        x = keys(shape, dtype)
        cases.append((f"K2 {shape} {np.dtype(dtype).name}", lambda x=x: bitonic.sort_tile(x),
                      lambda x=x: bitonic.sort_tile_plain(x)))
    return cases


def pair_cases(dev, gen):
    """(label, call, plain call) for each pair request timed."""
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
    ap.add_argument("sort", choices=sorted(KERNEL_PREFIX))
    ap.add_argument("variants", nargs="+", help='each a quoted list of NAME=VALUE, e.g. "kLogKeyE=3"')
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=21, help="calls timed a round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sort_variant_times.py: no CUDA device")
    variants = [parse_variant(v) for v in args.variants]
    libs = build(variants)
    dev = torch.device("cuda")
    todo = (tile_cases if args.sort == "tile" else pair_cases)(dev, np.random.default_rng(0))
    times = {(i, label): [] for i in range(len(libs)) for label, _, _ in todo}
    for i, lib in enumerate(libs):
        _build._libs["bitonic"] = lib
        for label, fn, plain in todo:
            got, want = fn(), plain()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if not all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want)):
                sys.exit(f"sort_variant_times.py: variant {variants[i]} {label} differs from the plain version")
    for rnd in range(args.rounds):
        order = range(len(libs)) if rnd % 2 == 0 else reversed(range(len(libs)))
        for i in order:
            _build._libs["bitonic"] = libs[i]
            for label, fn, _ in todo:
                fn()
                times[i, label] += event_ms(fn, args.reps)
    for label, fn, _ in todo:
        for i, lib in enumerate(libs):
            _build._libs["bitonic"] = lib
            dev_ms, launches = device_ms(fn, KERNEL_PREFIX[args.sort])
            print(
                f"variant {i} {label}: {np.median(times[i, label]):.4f} ms by events "
                f"(median of {len(times[i, label])}), {dev_ms:.4f} ms on the card, {launches} launches",
                flush=True,
            )
    _build._libs.pop("bitonic")


if __name__ == "__main__":
    main()
