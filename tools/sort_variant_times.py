"""Time the tile sort (K2), the pair sort (K5, K7), the merge (K3), the
count/rank (K1), the row sort (K4) or the pair row sort (K6) built with
other constants.

    python3 tools/sort_variant_times.py tile "kLogKeyE=4" "kLogKeyE=3"
    python3 tools/sort_variant_times.py tile "kLogKeyChunkBytes=15" "kLogKeyChunkBytes=16"
    python3 tools/sort_variant_times.py pairs "kLogPairChunk=11" "kLogPairChunk=12"
    python3 tools/sort_variant_times.py merge "" "csrc=build/parent/src/repro_torch/kernels/csrc"
    python3 tools/sort_variant_times.py bcr "" "kBcrThreadBuckets=0" "kBcrItems=32" "kBcrWarpsLarge=8"
    python3 tools/sort_variant_times.py rows "" "kLogKeyChunkBytes=16"
    python3 tools/sort_variant_times.py rowpairs "" "kLogRowPairBlocks=0" "kLogRowPairThreads=9"
        [--rounds 6] [--reps 21]

The sorts' tiers are fixed by plain constants in ``csrc/``: the keys a
thread holds (``kLogKeyE``) and the bytes a block holds
(``kLogKeyChunkBytes``) for K2 and K3 (``key_tiers.cuh``), the pairs a
block holds (``kLogPairChunk``) for K5 and K7 (``pair_tiers.cuh``; K4 takes K2's
tiers); K6's blocks a row (``kLogRowPairBlocks``, a cluster) and threads
a block (``kLogRowPairThreads``) in ``batched.cu``; ``csrc/partition.cu``
fixes K1's ids a
thread (``kBcrItems``, ``kBcrItemsLarge``), warps a block (``kBcrWarps``,
``kBcrWarpsLarge``), look-back window (``kBcrWindow``,
``kBcrWindowLarge``) and the bucket count up to which each thread counts
its own ids (``kBcrThreadBuckets``; 0 ranks every B by
``__match_any_sync``).  Each variant is a list of ``NAME=VALUE``
settings, and may name ``csrc=DIR``: the sources of another checkout (an
earlier commit unpacked with ``git archive``) in place of this one's.  This
script copies the sources once for each variant, with each constant
rewritten in the one source or header that defines it, builds the copies
(one nvcc each, all at once, into ``build/repro_torch/variant<i>/``) and
times each through the wrappers a caller uses (``bitonic.sort_tile``;
``bitonic.sort_pairs_tile_tagged`` and ``bitonic.sort_pairs_tile``;
``bitonic.merge_tile_pairs``; ``partition_kernel.bucket_count_rank``;
``batched.batched_row_sort``, both methods; ``batched.batched_row_sort_pairs``).  Each variant is first held bit
for bit against the plain version.  A time is the median over calls of
CUDA events around one wrapper call (its host work included); the
variants take turns round by round (A B, then B A, ...), so drift falls on
all alike.  The device time of one call (``torch.profiler``, every launch
of the kernel summed, K1's memset of its status words included) and its
kernel launches are printed beside it.  Needs a CUDA card and nvcc.
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
from repro_torch.kernels import _build, batched, bitonic, partition_kernel  # noqa: E402

# Each mode's source (csrc/<name>.cu) and the names of its device events
# for the profiler: its kernels, then anything else its call runs.
SOURCE = {"tile": "bitonic", "pairs": "bitonic", "merge": "bitonic", "bcr": "partition",
          "rows": "batched", "rowpairs": "batched"}
KERNEL_PREFIX = {
    "tile": ("key_",), "pairs": ("pair_",),
    # K3's kernels, and those of its first schedule (an earlier checkout)
    "merge": ("key_", "merge_first", "global_stage", "smem_stages"),
    "bcr": ("bcr", "Memset"),
    # K4's and K6's kernels, and those of their first schedule (smem_stages, smem_stages_pairs)
    "rows": ("key_", "smem_stages"), "rowpairs": ("pair_", "smem_stages"),
}


def parse_variant(text: str) -> dict:
    settings = {}
    for item in text.split():
        name, _, value = item.partition("=")
        if name == "csrc" and value:
            settings[name] = Path(value)
        elif not name.isidentifier() or not value.lstrip("-").isdigit():
            sys.exit(f"sort_variant_times.py: {item!r} is neither NAME=INTEGER nor csrc=DIR")
        else:
            settings[name] = int(value)
    return settings


def build(variants: list[dict], source: str) -> list[ctypes.CDLL]:
    procs = []
    for i, settings in enumerate(variants):
        out = _build.BUILD_DIR / f"variant{i}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(settings.get("csrc", _build.CSRC), out / "csrc")
        files = sorted((out / "csrc").glob("*.cu")) + sorted((out / "csrc").glob("*.cuh"))
        for name, value in settings.items():
            if name == "csrc":
                continue
            found = 0
            for path in files:
                text, k = re.subn(rf"constexpr int {name} = -?\d+;", f"constexpr int {name} = {value};",
                                  path.read_text())
                if k:
                    path.write_text(text)
                found += k
            if found != 1:
                sys.exit(f"sort_variant_times.py: csrc/ defines {name} {found} times, expected once")
        src = out / "csrc" / f"{source}.cu"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"{source}.so"), str(src)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for i, proc in enumerate(procs):
        output, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"sort_variant_times.py: nvcc failed for variant {variants[i]}:\n{output[-4000:]}")
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", output)) - {"0"})
        print(f"variant {i} {variants[i]}: built, spill stores {spills or 'none'}", flush=True)
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"variant{i}" / f"{source}.so"))
        for fn, argtypes in _build._SIGNATURES[source].items():
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


def device_ms(fn, prefixes: tuple[str, ...], traces: int = 5) -> tuple[float, int]:
    """Device time and kernel launches of one call, from torch.profiler
    (the median over ``traces`` calls traced in one session): the events
    named by any of ``prefixes``; a memset is no launch."""
    calls = devtrace.call_events(fn, traces) or [[]]
    calls = [[(name, ms) for name, ms in c if any(p in name for p in prefixes)] for c in calls]
    return (float(np.median([sum(ms for _, ms in c) for c in calls])),
            max(sum("Memset" not in name for name, _ in c) for c in calls))


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


def merge_cases(dev, gen):
    """(label, call, plain call, checked call) for K3 at the main path's
    half-pass and with 8-byte keys.  The timed call merges in place over
    and over (the network's work does not depend on the keys); the checked
    call merges a fresh copy."""
    cases = []
    for shape, dtype in (((36, 2, 1 << 19), np.int32), ((36, 2, 1 << 18), np.int64)):
        info = np.iinfo(dtype)
        raw = gen.integers(info.min, info.max, shape, dtype=np.int64, endpoint=True).astype(dtype)
        tiles = torch.sort(torch.from_numpy(raw).to(dev), dim=-1).values
        work = tiles.clone()
        cases.append((f"K3 {shape} {np.dtype(dtype).name}", lambda w=work: bitonic.merge_tile_pairs(w),
                      lambda t=tiles: bitonic.merge_tile_pairs_plain(t.clone()),
                      lambda t=tiles: bitonic.merge_tile_pairs(t.clone())))
    return cases


def bcr_cases(dev, gen):
    """(label, call, plain call) for K1 at every (ids, B) the main path
    hands it (chip_smoke.BCR_SHAPES): sort at 15,728,640 and 2^22 keys (P
    = 36 and 144), top_k at k = n/2, merge_sorted, long-row sort_segments
    (each row's ids in its own 37 buckets), and the kernels line's shape."""
    cases = []
    for n, nb in ((1 << 24, 37), (1 << 22, 37), (1 << 22, 145), (1 << 24, 33), (1 << 23, 37), (1 << 22, 2368),
                  (1 << 24, 145)):
        if nb == 2368:
            raw = np.arange(n) * 64 // n * 37 + gen.integers(0, 37, n)
        else:
            raw = gen.integers(0, nb, n)
        ids = torch.from_numpy(raw.astype(np.int32)).to(dev)
        cases.append((f"K1 (2^{n.bit_length() - 1}, {nb})",
                      lambda ids=ids, nb=nb: partition_kernel.bucket_count_rank(ids, nb),
                      lambda ids=ids, nb=nb: partition_kernel.bucket_count_rank_plain(ids, nb)))
    return cases


def row_lens(gen, rows: int, n: int, dev) -> torch.Tensor:
    return torch.from_numpy(gen.integers(0, n + 1, rows).astype(np.int32)).to(dev)


def row_cases(dev, gen):
    """(label, call, plain call) for K4 at sort_segments' batch, (64, 8192),
    with random lengths and garbage in the pads: int32 and int64 by both
    methods, float32, and int8 rows of 2^16 keys (the longest it takes)."""
    def keys(shape, dtype):
        if dtype == np.float32:
            return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(dev)
        info = np.iinfo(dtype)
        return torch.from_numpy(gen.integers(info.min, info.max, shape, dtype=np.int64, endpoint=True).astype(dtype)).to(dev)

    cases = []
    for shape, dtype, methods in (((64, 8192), np.int32, batched.METHODS), ((64, 8192), np.float32, ("bitonic",)),
                                  ((64, 8192), np.int64, batched.METHODS), ((64, 1 << 16), np.int8, ("bitonic",))):
        x, lens = keys(shape, dtype), row_lens(gen, shape[0], shape[1], dev)
        for m in methods:
            cases.append((f"K4 {shape} {np.dtype(dtype).name} {m}",
                          lambda x=x, lens=lens, m=m: batched.batched_row_sort(x, lens, method=m),
                          lambda x=x, lens=lens, m=m: batched.batched_row_sort_plain(x, lens, method=m)))
    return cases


def row_pair_cases(dev, gen):
    """(label, call, plain call) for K6 at (64, 8192) int32/int32 (the
    kernels line's shape), int64/float64 and a shorter row."""
    cases = []
    for shape, kdt, vdt in (((64, 8192), torch.int32, torch.int32), ((64, 8192), torch.int64, torch.float64),
                            ((64, 2048), torch.int32, torch.int32)):
        info = torch.iinfo(kdt)
        k = torch.from_numpy(gen.integers(info.min, info.max, shape, endpoint=True)).to(kdt).to(dev)
        v = torch.from_numpy(gen.integers(-(2**62), 2**62, shape)).to(bitonic._BITS[vdt.itemsize]).view(vdt).to(dev)
        lens = row_lens(gen, shape[0], shape[1], dev)
        cases.append((f"K6 {shape} {str(kdt)[6:]}/{str(vdt)[6:]}",
                      lambda k=k, v=v, lens=lens: batched.batched_row_sort_pairs(k, v, lens),
                      lambda k=k, v=v, lens=lens: batched.batched_row_sort_pairs_plain(k, v, lens)))
    return cases


CASES = {"tile": tile_cases, "pairs": pair_cases, "merge": merge_cases, "bcr": bcr_cases, "rows": row_cases,
         "rowpairs": row_pair_cases}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sort", choices=sorted(SOURCE))
    ap.add_argument("variants", nargs="+", help='each a quoted list of NAME=VALUE, e.g. "kLogKeyE=3"')
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=21, help="calls timed a round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sort_variant_times.py: no CUDA device")
    variants = [parse_variant(v) for v in args.variants]
    source = SOURCE[args.sort]
    libs = build(variants, source)
    dev = torch.device("cuda")
    todo = CASES[args.sort](dev, np.random.default_rng(0))
    times = {(i, case[0]): [] for i in range(len(libs)) for case in todo}
    for i, lib in enumerate(libs):
        _build._libs[source] = lib
        for label, fn, plain, *checked in todo:
            got, want = (checked[0] if checked else fn)(), plain()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if not all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want)):
                sys.exit(f"sort_variant_times.py: variant {variants[i]} {label} differs from the plain version")
    for rnd in range(args.rounds):
        order = range(len(libs)) if rnd % 2 == 0 else reversed(range(len(libs)))
        for i in order:
            _build._libs[source] = libs[i]
            for label, fn, *_ in todo:
                fn()
                times[i, label] += event_ms(fn, args.reps)
    for label, fn, *_ in todo:
        for i, lib in enumerate(libs):
            _build._libs[source] = lib
            dev_ms, launches = device_ms(fn, KERNEL_PREFIX[args.sort])
            print(
                f"variant {i} {label}: {np.median(times[i, label]):.4f} ms by events "
                f"(median of {len(times[i, label])}), {dev_ms:.4f} ms on the card, {launches} launches",
                flush=True,
            )
    _build._libs.pop(source)


if __name__ == "__main__":
    main()
