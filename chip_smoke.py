"""Drive the PyTorch/CUDA port on one GPU and hold every kernel to its plain version.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero and prints
no result line):

1. preflight: the card, torch, CUDA and nvcc versions; build every kernel
   from ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. every kernel against its plain torch version on the card, bit for bit,
   at the main path's shapes, with CUDA-event times beside the bound, the
   plain version's time and the library sort's; the tile sort K2 also at
   every boundary of its tiers (128 to 2^20 keys, 1, 3 and 36 rows, five
   key dtypes, heavy ties, float32 signed zeros) and timed at every shape
   the main path hands it; the merge K3 at every boundary of its tiers
   (2^8 to 2^21 keys a merged pair, 2 to 5 tiles a row, both half-passes,
   the same dtypes and cases) and timed at the path's (36, 2, 2^19); the
   count/rank K1 at every tile boundary for 1 to 4,096 buckets, one-bucket
   and out-of-range ids, and timed at every (ids, B) of the path; the pair
   sorts K5 and K7 at every boundary of theirs (128 to 2^19 pairs, 1 and
   3 rows, heavy ties, int64 keys with float64 payloads), each with the
   device time of each of its launches from ``torch.profiler``; the row
   sort K4 and the pair row sort K6 at every boundary of theirs (128 keys
   to 64 KiB a row, every key dtype, both K4 methods, 16-value ties,
   sentinel keys, garbage pads, lengths at a home run's edges and past
   both ends), K4 timed at (64, 8192) int32, float32 and int64 and at
   (64, 2^16) int8, K6 at (64, 8192) int32/int32 and int64/float64, each
   with its device time and kernel launches a call;
3. the main path, ``SortEngine.sort``, against ``np.sort``: six dtypes x
   five distributions at n = 100,000, skewed inputs at 60,000 (sampled
   splitters, large capacities, a forced overflow), int64 keys spanning
   the whole type, then paper scale (2^22 and 15,728,640 int32 keys, and
   2^22 keys on the 144-processor OHHC), and a profile of two requests;
4. ``SortEngine.sort_segments`` on 64 segments of 1,000-8,192 keys with
   each row backend, against ``np.sort`` per row, then 64 segments of
   9,000-65,536 keys, which take the bucket path;
5. the pairs path: ``SortEngine.sort_pairs`` with a flat payload at a
   serving batch (256 request lengths, ``ServeEngine.order_by_length``'s
   call) and at 2^19 pairs, ``argsort_keys`` at 2^19 int32 and int64
   keys, and a three-leaf pytree payload at 4,096 and 2^19 keys, each
   against numpy; a profile of one ``argsort_keys`` at 2^19;
6. the workloads: ``top_k`` at 15,728,640 int32 keys with k = n/2 (the
   sim path) and k = 1,000 (the host head), and ``merge_sorted`` of 2^20
   new keys into a sorted 2^22 buffer, against ``np.sort``;
7. serving: (a) ``Sortd`` over ``SortEngine()`` with the reference sortd
   benchmark's request mix, 600 requests from 8 closed-loop clients, int32
   and float32, at its ``SortdConfig(max_batch=64, max_wait_s=0.005,
   max_bucket=4096)`` and at the default ``SortdConfig()`` with a 15 %
   tail of 8,193-32,768-key requests (the bucket path, K1 and K2), then
   16 ``submit_merge`` ticks into a growing buffer; (b) the fault ladder:
   the five scenarios of the reference's fault benchmark at d_h = 1
   through ``Sortd.set_fault_scenario``, 100 requests each, then healed;
   the degraded flushes carry the slowdown a CPU engine quotes, and the
   two impossible scenarios launch no kernel; (c) ``SortdFleet`` of four
   workers, 800 requests of ``loadgen.request_mix``, healthy and with the
   busiest worker killed mid-load; every result against ``np.sort``;
8. conformance on the card (``repro_torch.verify``): (a) the smoke run as
   ``python -m repro_torch.verify --smoke`` runs it (252 sort, 66
   segment, 30 fault and 90 op cells, the cross-check, the property
   battery, the drift gate against ``tests/baselines/verify_smoke_torch.json``),
   then the fault cells of the two impossible classes again, which must
   launch nothing; (b) the port's ``--full`` grid (1,560 sort cells, the
   130 int64 sim cells among them) with the cross-check; (c) paper scale:
   int32 {random, dupes, sorted, local} at 4,194,304 and 15,728,640 keys
   through sim/paper, sim/sampled and host/paper at d_h = 1, random at
   4,194,304 through sim/paper at d_h = 2 and 3, cross-checked, and the
   metamorphic battery and fault replay on the 4,194,304-key random input;
   fails unless K1-K5 launched and K6, K7 did not;
9. the model layer: DeepSeek-V2-Lite-16B at full width (27 layers,
   d_model 2048, MLA rank 512, 64 experts top-6 + 2 shared, vocab
   102,400; 16.21 B float32 parameters made on the card from a seeded
   generator, bf16 compute) served by ``ServeEngine.generate`` for 4 and
   then 16 requests of the reference launcher's mix (prompts of 4-47
   tokens, 16 new tokens each, ``max_len`` 256), cold and warm: prefill
   and decode-step times synchronised with the card, tokens/s, the card's
   busy share, exactly 27·16 launches of K1 (one an MoE layer a forward)
   and one of K5 (``order_by_length``) a run, the same tokens twice; then
   (a) one layer's ``apply_moe`` with K1 and with its plain version and
   (b) its ``sorted`` and ``argsort`` dispatches, bit for bit, (c)
   float32 prefill + decode against ``forward`` within 2e-2 (capacity
   factor 64, no TF32), (d) ``order_by_length`` against the stable
   argsort; and K1 timed at the dispatch's shapes beside
   ``torch.bincount`` plus a stable ``torch.sort``;
10. the other model families at full width, each built on the card from a
   seeded generator, served, checked and freed before the next (the
   card's allocated memory back at its level after DeepSeek is freed):
   Zamba2-2.7B (hybrid: 54 Mamba2 blocks, d_model 2560, one shared
   attention + MLP block every 6; 9.07 GiB of float32 weights) served
   for 4 and then 16 requests as in phase 9, with K5 once and K1 never a
   ``generate``, the same tokens twice, its counted weights equal to
   ``cfg.param_count()`` plus the shared block's ``wq`` (2560^2, which
   the reference's count leaves out), (c) float32 prefill of 600 tokens
   (two 256-position chunks and a padded tail) + 2 decode steps against
   ``forward`` within 2e-2, and (e) one layer's ``ssd_chunked`` at S =
   600 against the decode update applied position by position within
   1e-3 relative; then mamba2-370m (ssm), whisper-tiny (encdec) and
   qwen2-vl-7b (vlm) served for 4 requests each, with (c) at 602 tokens
   (mamba2, and (e)), against random (B, 1500, 384) encoder frames
   (whisper) and with 1,024 random vision embeddings on a 32 x 32 patch
   grid of M-RoPE positions at S = 1,100 (qwen2-vl); every time beside
   the card's name and power limit;
11. training on the card (the card's memory back after phase 10): (a)
   DeepSeek-V2-Lite-16B at full width, 4 of its 27 layers (float32
   parameters, gradients and AdamW moments of all 27 take 241.6 GiB), a
   batch of 2 x 4,096 tokens (``train_4k``'s length), trained 6 steps
   through ``Trainer(device="cuda")`` with remat and the ``sorted`` MoE
   dispatch: finite losses, the last below the first, exactly 8 launches
   of K1 a step (4 MoE layers, forward and remat recompute); step ms,
   tokens/s, max allocated, and a seventh step under the profiler for the
   card's busy share and top kernels; (b) in a process of its own with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and deterministic algorithms, one
   layer's loss and every gradient leaf with the ``sorted`` (K1) and the
   ``argsort`` dispatch bit for bit; K1 timed at the training shape
   (49,152 ids, 64 buckets) beside its plain version and
   ``torch.bincount`` + a stable ``torch.sort``; (c) ``python -m
   repro_torch.launch.train --arch mamba2-370m --steps 3`` at full width
   in a subprocess; (d) mamba2-370m trained 3 steps with a checkpoint at
   step 2, then resumed by a second ``Trainer`` at step 2 with the data
   at step 2, its loss equal to the first run's bit for bit;
12. the perf gate (``repro_torch.perf``), run between phases 8 and 9:
   the card calibrated (a 1 GiB device copy, a float32 GEMM at k = 8,192
   without TF32) and printed beside the H100 data sheet; (a) all eight
   suites at full scope through ``run_suite(device="cuda")`` at the
   reference CLI's warmup 2 and 5 repeats, each case's median, IQR,
   ``norm_ratio`` and ``pct_of_roofline`` printed, failing on a case
   that raises, a non-finite or non-positive time, or a normalised case
   above 105 % of the calibrated roofline or 100 % of the data sheet's;
   (b) ``SortEngine(host_threshold=2^25).sort`` of 15,728,640 random
   int32 keys through ``run_case`` (warmup 1, 3 repeats), equal to
   ``np.sort`` outside the clock; (c) (a) recorded into a temporary
   directory and a second run of the engine and kernels suites judged
   against it by ``python -m repro_torch.perf --slack 2`` in process, and
   (a) judged against the committed ``src/repro_torch/perf/baselines/``,
   failing on a case new to or missing from either (timing verdicts are
   printed, not gated); (d) fails unless K1, K2, K4 and K5 launched in
   (a) and K3 in (b), and if K6 or K7 launched;
13. a ``kernels`` JSON line with each kernel's launches on its path
   (phase 3 for the sort kernels, the short segments for the row kernel,
   phase 5 for the tagged pair kernel, each plus its launches in phases
   7, 8, 9, 10, 11 and 12 (a) and (b); the untagged pair kernel and the
   pair row kernel have no caller on any path and are checked in phase 2 only), each
   kernel's device time and launches a call (the script fails if the
   profiler gave none after three sessions), and K1's times at the
   training shape; the launches of single requests are printed on their
   own lines.

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import devtrace  # noqa: E402
from repro_torch.core import OHHCTopology, SortEngine, SortPlan  # noqa: E402
from repro_torch.data import ALL_DISTRIBUTIONS, make_array  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    KERNELS,
    _build,
    batched,
    bitonic,
    launch_counts,
    ops,
    partition_kernel,
    ref,
    reset_launches,
)
from repro_torch.net.faults import FaultScenario  # noqa: E402
from repro_torch.serve import ChaosConfig, FleetConfig, Sortd, SortdConfig, SortdFleet  # noqa: E402
from repro_torch.serve.fleet.loadgen import drive_closed_loop, request_mix  # noqa: E402
from repro_torch.verify import cross_check, differential, grid, metamorphic_checks  # noqa: E402
from repro_torch.verify.properties import fault_replay_for_engine_run  # noqa: E402
from repro_torch.verify import __main__ as verify_cli  # noqa: E402
from repro_torch import perf  # noqa: E402
from repro_torch.perf import __main__ as perf_cli, suites as perf_suites  # noqa: E402
from repro_torch.roofline import H100  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.serve import synthetic_requests  # noqa: E402
from repro_torch.models import layers, lm, moe, ssm  # noqa: E402
from repro_torch.models.common import NO_SHARD, layer, tree_leaves  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.train_step import make_grad_fn  # noqa: E402

DEV = torch.device("cuda")
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the float32 rate
# outside the tensor cores, used for every key type's compare-exchange
# operations (the table lists no separate integer rate).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
DTYPES = ("int8", "int16", "int32", "int64", "uint32", "float32")
TORCH_KEY = {
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "float32": torch.float32,
}
PAPER_MAX_KEYS = 15_728_640  # 60 MB of int32, the paper's largest size


def fail(msg: str):
    raise RuntimeError(msg)


def sh(*cmd: str) -> str:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        fail(f"{' '.join(cmd)} failed: {r.stderr.strip()}")
    return r.stdout.strip()


def smi() -> str:
    return sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` from CUDA events, warmup outside the clock."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least milliseconds for ``nbytes`` moved and ``ops`` operations done.

    Count what the function needs, not what a kernel's algorithm does: a
    sort of n keys needs about n·log2(n) comparisons (the comparison-sort
    lower bound, far below a bitonic network's compare-exchanges), a merge
    of two n-key tiles 2n."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sort_comparisons(lens) -> float:
    return float(sum(n * math.log2(n) for n in lens if n > 1))


def bits(t: torch.Tensor) -> torch.Tensor:
    """Integer view of a key tensor, so equality is bit for bit."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    torch.cuda.synchronize()
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(bits(a), bits(b)):
        fail(f"{what}: kernel and plain version differ")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def random_keys(shape, dtype: torch.dtype, gen: np.random.Generator) -> torch.Tensor:
    if dtype.is_floating_point:
        x = gen.standard_normal(shape).astype(np.float32)
    else:
        info = torch.iinfo(dtype)
        x = gen.integers(info.min, info.max, shape, dtype=np.int64, endpoint=True)
        x = x.astype(str(dtype).removeprefix("torch."))
    return torch.from_numpy(x).to(DEV)


# ----------------------------------------------------------------- phase 1
def preflight() -> None:
    print("card:", smi())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    print(sh(_build.nvcc_path(), "--version").splitlines()[-1])
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_build.SOURCES)}")
    for name in _build.SOURCES:
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", _build.build_log(name))]
        spills = re.findall(r"(\d+) bytes spill stores", _build.build_log(name))
        print(
            f"  {name}.cu: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
            f"spill stores {sorted(set(spills))}"
        )
        # ptxas reports each kernel's spills after its "Compiling entry function" line
        for fn, spill in re.findall(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores", _build.build_log(name), re.S
        ):
            if int(spill):
                print(f"    spills {spill} bytes: {fn}")


# ----------------------------------------------------------------- phase 2
def kernel_checks() -> dict:
    gen = np.random.default_rng(0)
    rows = {}

    rows["sort_tile"] = tile_kernel_checks(gen)

    rows["merge_tiles"] = merge_kernel_checks(gen)
    rows["bucket_count_rank"] = bcr_kernel_checks(gen)

    rows["batched_row_sort"] = row_kernel_checks(gen)
    rows.update(pair_kernel_checks(gen))
    for name, r in rows.items():
        print(
            f"kernel {name} {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}), plain {r['plain_ms']:.3f} ms, library {r['library_ms']}, "
            f"max_abs_err {r['max_abs_err']} {r.get('extra', '')}"
            + (f" device {r['device_ms']:.4f} ms" if r.get("device_ms") is not None else "")
        )
    return rows


# Row lengths at every boundary of the row sort's tiers (csrc/batched.cu on
# key_tiers.cuh): a partial warp, one warp's 512 keys, one chunk of int64
# (2^12), int32 (2^13) and int8/int16 (2^14), then device windows up to
# 64 KiB a row.
ROW_SIZES = (128, 512, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16)


def row_batch(nrows: int, n: int, dtype: torch.dtype, gen: np.random.Generator):
    """Keys from 16 values, some equal to the sentinel (float32: signed
    zeros too), lengths at a home run's edges, the row's, past both ends
    and random, and garbage in the pads."""
    raw = torch.from_numpy(gen.integers(0, 16, (nrows, n))).to(DEV)
    if dtype.is_floating_point:
        x = (raw - 8).to(dtype)
        x[raw == 15] = float("inf")
        x[(raw == 8) & torch.from_numpy(gen.random((nrows, n)) < 0.5).to(DEV)] = -0.0
    else:
        x = raw.to(dtype)
        x[raw == 15] = torch.iinfo(dtype).max
    lens = np.concatenate([[0, 1, 15, 16, 17, n - 1, n, -3, n + 5], gen.integers(0, n + 1, nrows - 9)])
    lens = torch.from_numpy(lens.astype(np.int32)).to(DEV)
    pad = torch.arange(n, device=DEV)[None, :] >= lens[:, None]
    return torch.where(pad, random_keys((nrows, n), dtype, gen), x), lens


def row_kernel_checks(gen: np.random.Generator) -> dict:
    """K4 bit for bit against its plain version at every tier boundary,
    every key dtype, both methods; at the kernels line's (64, 8192) int32
    against np.sort too; then timed at (64, 8192) int32 by events and on
    the card, with its launches a call, for both methods, and at int64
    (64, 8192) and int8 (64, 2^16)."""
    err, batches = 0.0, 0
    for name in ("int8", "int16", "int32", "int64", "float32"):
        dt = TORCH_KEY[name]
        for n in ROW_SIZES:
            if n * torch.empty((), dtype=dt).element_size() > batched.MAX_ROW_BYTES:
                continue
            x, lens = row_batch(16, n, dt, gen)
            for method in batched.METHODS:
                err = max(err, same(batched.batched_row_sort(x, lens, method=method),
                                    batched.batched_row_sort_plain(x, lens, method=method),
                                    f"batched_row_sort {name} ({x.shape[0]}, {n}) {method}"))
                batches += 1
    print(f"batched_row_sort: {batches} batches at every tier boundary equal the plain version bit for bit")
    x = random_keys((64, 8192), torch.int32, gen)
    lens = torch.from_numpy(gen.integers(0, 8193, 64).astype(np.int32)).to(DEV)
    for method in batched.METHODS:
        out = batched.batched_row_sort(x, lens, method=method)
        err = max(err, same(out, batched.batched_row_sort_plain(x, lens, method=method), f"batched {method}"))
        host = out.cpu().numpy()
        for i, ln in enumerate(lens.cpu().tolist()):
            if not np.array_equal(host[i, :ln], np.sort(x[i, :ln].cpu().numpy())):
                fail(f"batched_row_sort {method} row {i} is not np.sort")
            if (host[i, ln:] != np.iinfo(np.int32).max).any():
                fail(f"batched_row_sort {method} row {i} pad is not the sentinel")
    timed = {}
    for shape, dt in (((64, 8192), torch.int32), ((64, 8192), torch.float32), ((64, 8192), torch.int64),
                      ((64, 1 << 16), torch.int8)):
        y = x if dt == torch.int32 else random_keys(shape, dt, gen)
        ylens = lens if dt == torch.int32 else torch.from_numpy(gen.integers(0, shape[1] + 1, 64).astype(np.int32)).to(DEV)
        for method in batched.METHODS if not dt.is_floating_point else ("bitonic",):
            err = max(err, same(batched.batched_row_sort(y, ylens, method=method),
                                batched.batched_row_sort_plain(y, ylens, method=method),
                                f"batched_row_sort {shape} {dt} {method}"))
            label = f"batched_row_sort {shape} {str(dt)[6:]} {method}"
            ms = cuda_ms(lambda m=method: batched.batched_row_sort(y, ylens, method=m), reps=11)
            tiers = launch_profile(label, lambda m=method: batched.batched_row_sort(y, ylens, method=m), "key_")
            profile_request(label, lambda m=method: batched.batched_row_sort(y, ylens, method=m))
            print(f"kernel {label}: {ms:.4f} ms by events, device {tiers.get('device_ms')} ms, "
                  f"{tiers.get('launches')} launches a call")
            timed[shape, dt, method] = ms, tiers
    plain = cuda_ms(lambda: batched.batched_row_sort_plain(x, lens, method="bitonic"), reps=3)
    lib = cuda_ms(lambda: torch.sort(x, dim=-1))
    # the kernel need not read the pad cells, but writes every cell
    valid = int(lens.sum())
    b, by = bound((valid + x.numel()) * 4 + 4 * 64, sort_comparisons(lens.cpu().tolist()))
    ms, tiers = timed[(64, 8192), torch.int32, "bitonic"]
    ms2, tiers2 = timed[(64, 8192), torch.int32, "bitonic2op"]
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/batched.cu",
        replaces="src/repro/kernels/batched.py:145", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(64, 8192) int32", device_ms=tiers.get("device_ms"), launches_per_call=tiers.get("launches"),
        extra=f"bitonic2op {ms2:.4f} ms, device {tiers2.get('device_ms')} ms",
    )


# Segment lengths at every boundary of the merge's tiers (csrc/bitonic.cu
# merge_pairs): 2^8 .. 2^21 keys a merged pair: within one chunk (read
# flipped by the chunk launch) for every key width, one to three distances
# past it (the flip window alone), and longer (device windows).
MERGE_LOG_SEGS = range(8, 22)


def merge_kernel_checks(gen: np.random.Generator) -> dict:
    """K3 bit for bit against its plain version at every tier boundary (2
    to 5 tiles a row, both half-passes), every key dtype, heavy ties and
    signed zeros, and against torch.sort of each merged pair; then timed
    at the main path's shape, (36, 2, 2^19), beside torch.sort over the
    same rows, with the device time of each launch."""
    err, batches = 0.0, 0
    for name in ("int8", "int16", "int32", "int64", "float32"):
        for case in ("spread", "heavy_ties") + (("signed_zeros",) if name == "float32" else ()):
            for log_seg in MERGE_LOG_SEGS:
                m = 1 << (log_seg - 1)
                configs = [(t, f) for t in (2, 3, 4, 5) for f in (0, 1)] if log_seg <= 16 else [(2, 0), (3, 1)]
                for tiles, first in configs:
                    nrows = 2 if log_seg <= 16 else 1
                    buf = torch.sort(tile_keys((nrows, tiles, m), TORCH_KEY[name], case, gen), dim=-1).values
                    what = f"merge_tile_pairs {name} {case} 2^{log_seg} keys a pair, {tiles} tiles, first={first}"
                    got = bitonic.merge_tile_pairs(buf.clone(), first)
                    err = max(err, same(got, bitonic.merge_tile_pairs_plain(buf.clone(), first), what))
                    k = (tiles - first) // 2
                    span = slice(first, first + 2 * k)
                    if not torch.equal(got[:, span].reshape(nrows, k, 2 * m),
                                       torch.sort(buf[:, span].reshape(nrows, k, 2 * m), dim=-1).values):
                        fail(f"{what}: not torch.sort of each pair")
                    batches += 1
    print(f"merge_tile_pairs: {batches} batches at every tier boundary equal the plain version bit for bit")
    # the two-tile form at 2^19 (the earlier PRs' row)
    n = 1 << 19
    a = torch.sort(random_keys((n,), torch.int32, gen)).values
    c = torch.sort(random_keys((n,), torch.int32, gen)).values
    lo, hi = bitonic.merge_tiles(a, c)
    plo, phi = bitonic.merge_tiles_plain(a, c)
    err = max(err, same(lo, plo, "merge_tiles lo"), same(hi, phi, "merge_tiles hi"))
    rlo, rhi = ref.ref_merge(a, c)
    if not (torch.equal(lo, rlo) and torch.equal(hi, rhi)):
        fail("merge_tiles disagrees with torch.sort of the union")
    two = launch_profile("merge_tiles two 2^19 int32 tiles", lambda: bitonic.merge_tiles(a, c), "key_")
    print(f"kernel merge_tiles two 2^19 int32 tiles: {cuda_ms(lambda: bitonic.merge_tiles(a, c), reps=11):.4f} ms "
          f"by events, device {two.get('device_ms')} ms, {two.get('launches')} launches, "
          f"torch.sort of the union {cuda_ms(lambda: torch.sort(torch.cat([a, c])), reps=11):.4f} ms")
    # the main path's half-pass at 15,728,640 keys: 36 rows of two tiles
    tiles = torch.sort(random_keys((36, 2, n), torch.int32, gen), dim=-1).values
    got = bitonic.merge_tile_pairs(tiles.clone())
    err = max(err, same(got, bitonic.merge_tile_pairs_plain(tiles.clone()), "merge_tile_pairs (36, 2, 2^19)"))
    union = tiles.view(36, 2 * n)
    if not torch.equal(got.view(36, 2 * n), torch.sort(union, dim=-1).values):
        fail("merge_tile_pairs (36, 2, 2^19) disagrees with torch.sort of each row")
    # in place, over and over: the network's work does not depend on the keys
    work = tiles.clone()
    ms = cuda_ms(lambda: bitonic.merge_tile_pairs(work), reps=11)
    tiers = launch_profile("merge_tile_pairs (36, 2, 2^19) int32", lambda: bitonic.merge_tile_pairs(work), "key_")
    plain = cuda_ms(lambda: bitonic.merge_tile_pairs_plain(tiles.clone()), reps=3)
    lib = cuda_ms(lambda: torch.sort(union, dim=-1), reps=11)
    b, by = bound(2 * tiles.numel() * 4, tiles.numel())
    print(f"kernel merge_tile_pairs (36, 2, 2^19) int32: {ms:.4f} ms by events, device {tiers.get('device_ms')} ms, "
          f"{tiers.get('launches')} launches, torch.sort over (36, 2^20) {lib:.4f} ms, bound {b:.4f} ms")
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bitonic.cu",
        replaces="src/repro/kernels/bitonic.py:236", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(36, 2, 2^19) int32", device_ms=tiers.get("device_ms"),
        launches_per_call=tiers.get("launches"),
    )


# The (ids, B) the main path hands K1: SortEngine.sort at 15,728,640 keys
# and at 2^22 (P = 36 and 144), top_k at k = n/2, merge_sorted of 2^20
# keys into 2^22, long-row sort_segments (64 rows x 37 buckets, each row's
# ids in its own buckets), and the kernels line's shape, kept from earlier PRs.
BCR_SHAPES = ((1 << 24, 37), (1 << 22, 37), (1 << 22, 145), (1 << 24, 33), (1 << 23, 37), (1 << 22, 2368),
              (1 << 24, 145))


def bcr_ids(n: int, nb: int, gen: np.random.Generator) -> torch.Tensor:
    if nb == 2368:  # 64 rows of 37 buckets, as scatter_rows_to_buckets offsets them
        row = np.arange(n) * 64 // n
        return torch.from_numpy((row * 37 + gen.integers(0, 37, n)).astype(np.int32)).to(DEV)
    return torch.from_numpy(gen.integers(0, nb, n).astype(np.int32)).to(DEV)


def bcr_profile(fn, reps: int = 5, attempts: int = 3) -> tuple["float | None", "int | None"]:
    """Device time of one call (its kernel and the memset of its status
    words; median of ``reps`` calls) and its kernel launches; a profiler
    session that lost the calls' markers is traced again, up to
    ``attempts`` sessions."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        calls = devtrace.call_events(fn, reps)
        if calls:
            return (float(np.median([sum(t for _, t in c) for c in calls])),
                    max(sum("bcr" in n for n, _ in c) for c in calls))
    return None, None


def bcr_kernel_checks(gen: np.random.Generator) -> dict:
    """K1 against its plain version and torch.bincount at every boundary
    of its tiles and at every bucket count the path uses, with every id
    in one bucket and with out-of-range ids; then timed at every shape
    the main path hands it."""
    lib = _build.load("partition")
    err, checks = 0.0, 0

    def check(ids, nb, what):
        kc, kr = partition_kernel.bucket_count_rank(ids, nb)
        pc, pr = partition_kernel.bucket_count_rank_plain(ids, nb)
        e = max(same(kc, pc, f"bucket_count_rank counts {what}"), same(kr, pr, f"bucket_count_rank ranks {what}"))
        valid = ids[(ids >= 0) & (ids < nb)]
        if not torch.equal(kc, torch.bincount(valid, minlength=nb).to(torch.int32)):
            fail(f"bucket_count_rank {what}: counts disagree with torch.bincount")
        return e

    for nb in (1, 2, 37, 145, 2368, 4096):
        tile = lib.rt_bcr_tile(nb)  # ids a tile at this B
        for n in (1, tile - 1, tile, tile + 1, 1 << 22, 1 << 24):
            ids = torch.from_numpy(gen.integers(0, nb, n).astype(np.int32)).to(DEV)
            err = max(err, check(ids, nb, f"n={n} B={nb}"))
            checks += 1
    for nb in (1, 37, 4096):
        for n in (lib.rt_bcr_tile(nb) + 1, 1 << 24):
            # every id in one bucket; then a third of them out of range
            err = max(err, check(torch.full((n,), nb - 1, dtype=torch.int32, device=DEV), nb, f"one bucket n={n} B={nb}"))
            ids = torch.from_numpy(gen.integers(0, nb, n).astype(np.int32)).to(DEV)
            ids[::6], ids[1::6], ids[2::6] = -3, nb, -(2**31)
            err = max(err, check(ids, nb, f"out of range n={n} B={nb}"))
            checks += 2
    print(f"bucket_count_rank: {checks} calls equal the plain version and torch.bincount")
    row = None
    for n, nb in BCR_SHAPES:
        ids = bcr_ids(n, nb, gen)
        ms = cuda_ms(lambda: partition_kernel.bucket_count_rank(ids, nb), reps=11)
        dev_ms, launches = bcr_profile(lambda: partition_kernel.bucket_count_rank(ids, nb))
        b, by = bound(4 * n + 4 * nb + 4 * n, 2 * n)
        print(f"kernel bucket_count_rank n=2^{n.bit_length() - 1} B={nb}: {ms:.4f} ms by events, device {dev_ms} ms "
              f"(kernel and memset), {launches} kernel launches, bound {b:.4f} ms")
        if launches is not None and launches != 1:
            fail(f"bucket_count_rank made {launches} kernel launches in one call, not 1")
        row = ids, nb, ms, dev_ms, launches, b, by
    ids, nb, ms, dev_ms, launches, b, by = row  # the last shape: (2^24, 145)
    plain = cuda_ms(lambda: partition_kernel.bucket_count_rank_plain(ids, nb), reps=3)
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/partition.cu",
        replaces="src/repro/kernels/partition_kernel.py:84", max_abs_err=err,
        # no one PyTorch call gives both the counts and the stable ranks
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        shape="2^24 ids, B=145", device_ms=dev_ms, launches_per_call=launches,
    )


def payload(shape, dtype: torch.dtype, gen: np.random.Generator) -> torch.Tensor:
    """Random payload bits of ``dtype`` (any width 1, 2, 4 or 8 bytes)."""
    bits = bitonic._BITS[torch.empty((), dtype=dtype).element_size()]
    raw = torch.from_numpy(gen.integers(-(2**62), 2**62, shape)).to(bits)
    return raw.view(dtype).to(DEV)


def same_pairs(got, want, what: str) -> float:
    """Keys and payloads of a pair sort, bit for bit."""
    err = same(got[0], want[0], f"{what} keys")
    bits = bitonic._BITS[got[1].element_size()]
    same(got[1].view(bits), want[1].view(bits), f"{what} payloads")
    return err


# Row lengths at every boundary of the pair sort's tiers (csrc/bitonic.cu):
# under one warp's 256 pairs, one warp, one 2,048-pair chunk, two and
# four chunks (the first lengths with device-memory windows), then longer
# rows up to argsort_keys' full width.
PAIR_SIZES = (128, 256, 1 << 11, 1 << 12, 1 << 13, 1 << 15, 1 << 16, 1 << 19)
# Pair row lengths at every boundary of the pair row sort (csrc/batched.cu
# pair_chunk_rows): under one warp's 256 pairs, one warp, more runs a
# thread up to a row that fills one block's shared memory, and rows past
# it (the fill in torch, then the pair sort's launches).
ROW_PAIR_SIZES = (128, 256, 512, 2048, 8192, 1 << 14, 1 << 15, 1 << 16)


def pair_keys(shape, heavy_ties: bool, gen: np.random.Generator) -> torch.Tensor:
    """int32 keys over the whole type, or drawn from 16 values (heavy ties)."""
    if heavy_ties:
        return torch.from_numpy(gen.integers(0, 16, shape).astype(np.int32)).to(DEV)
    return random_keys(shape, torch.int32, gen)


def launch_profile(label: str, fn, kind: str, reps: int = 5, attempts: int = 3) -> dict:
    """Device time of each kernel launch of one call of ``fn`` (``reps``
    calls traced in one profiler session, median over the calls), summed
    by the launch kinds of a tiered sort, whose kernel names start with
    ``kind`` (``pair_`` for K5 and K7, ``key_`` for K2): the first chunk
    launch (every stage whose distances fit one chunk: registers, warp
    shuffles, shared memory), the later chunk launches (one stage's
    distances below the chunk each) and the device windows (several longer
    distances each, through device memory).  Every call must show the same
    launches in the same order; a session that does not (the profiler lost
    events) is traced again, up to ``attempts`` sessions, else nothing is
    reported."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        calls = devtrace.call_events(fn, reps) or []
        calls = [[(n, t) for n, t in c if kind in n] for c in calls]
        names = [n for n, _ in calls[0]] if calls else []
        if names and all([n for n, _ in c] == names for c in calls):
            break
        print(f"tiers {label}: launches {[len(c) for c in calls]} in {reps} calls, not the same each call "
              f"(profiler session {attempt} of {attempts})")
    else:
        return {}
    ms = np.median(np.array([[t for _, t in c] for c in calls]), axis=0)
    chunk = [t for n, t in zip(names, ms) if f"{kind}chunk" in n]
    window = [t for n, t in zip(names, ms) if f"{kind}device" in n]
    out = dict(device_ms=float(ms.sum()), launches=len(names), first_ms=float(chunk[0]) if chunk else 0.0,
               later_chunks=len(chunk) - 1, later_ms=float(sum(chunk[1:])), windows=len(window),
               window_ms=float(sum(window)))
    print(
        f"tiers {label}: {len(names)} launches, {out['device_ms']:.4f} ms on the card = first chunk launch "
        f"{out['first_ms']:.4f} ms + {out['later_chunks']} chunk launches {out['later_ms']:.4f} ms "
        f"+ {out['windows']} device windows {out['window_ms']:.4f} ms"
    )
    return out


# Row lengths at every boundary of the tile sort's tiers (csrc/bitonic.cu:
# 16 keys a thread, 32 KiB chunks): 128 keys (a partial warp), one warp's
# 512, one chunk of int64 (2^12), int32 (2^13) and int8/int16 (2^14), two
# and four chunks (the first device windows), 2^17 and 2^18 (where a stage
# first takes two device windows for int64 and int32), 2^19 (for
# int8/int16) and 2^20.
TILE_SIZES = (128, 512, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20)
# The rows the main path hands K2: SortEngine.sort at 2^20 keys a row
# (the shape of the kernels line, kept comparable with earlier runs), at
# 15,728,640 keys, at 2^22 keys and at 2^22 on the 144-processor OHHC;
# top_k's kept rows at k = n/2; long-row sort_segments.
TILE_SHAPES = ((36, 1 << 20), (72, 1 << 19), (36, 1 << 18), (144, 1 << 17), (32, 1 << 19), (2304, 4096))


def tile_keys(shape, dtype: torch.dtype, case: str, gen: np.random.Generator) -> torch.Tensor:
    """Keys over the whole type, drawn from 16 values (heavy ties), or
    float32 keys about half of them -0.0 or +0.0 (signed zeros)."""
    if case == "heavy_ties":
        return torch.from_numpy(gen.integers(0, 16, shape)).to(dtype).to(DEV)
    x = random_keys(shape, dtype, gen)
    if case == "signed_zeros":
        zero = torch.from_numpy(gen.random(shape) < 0.5).to(DEV)
        neg = torch.from_numpy(gen.random(shape) < 0.5).to(DEV)
        x = torch.where(zero, torch.where(neg, -torch.zeros_like(x), torch.zeros_like(x)), x)
    return x


def tile_kernel_checks(gen: np.random.Generator) -> dict:
    """K2 bit for bit against its plain version at every tier boundary
    (1, 3 and 36 rows; 36 up to 2^16 keys a row), every key dtype, heavy
    ties and signed zeros, then at the main path's shapes, each timed by
    events and by device time beside torch.sort over the same rows."""
    err, batches = 0.0, 0
    for name in ("int8", "int16", "int32", "int64", "float32"):
        for case in ("spread", "heavy_ties") + (("signed_zeros",) if name == "float32" else ()):
            for n in TILE_SIZES:
                for nrows in (1, 3, 36) if n <= 1 << 16 else (1, 3):
                    x = tile_keys((nrows, n), TORCH_KEY[name], case, gen)
                    err = max(err, same(bitonic.sort_tile(x), bitonic.sort_tile_plain(x), f"sort_tile {name} {case} ({nrows}, {n})"))
                    batches += 1
    print(f"sort_tile: {batches} batches at every tier boundary equal the plain version bit for bit")
    timed = {}
    for shape in TILE_SHAPES:
        x = tile_keys(shape, torch.int32, "spread", gen)
        got = bitonic.sort_tile(x)
        err = max(err, same(got, bitonic.sort_tile_plain(x), f"sort_tile {shape}"))
        if not torch.equal(got, ref.ref_sort(x)):
            fail(f"sort_tile {shape} disagrees with torch.sort")
        ms = cuda_ms(lambda: bitonic.sort_tile(x), reps=11)
        lib = cuda_ms(lambda: torch.sort(x, dim=-1), reps=11)
        tiers = launch_profile(f"sort_tile {shape} int32", lambda: bitonic.sort_tile(x), "key_")
        b, by = bound(2 * x.numel() * 4, sort_comparisons([x.shape[1]] * x.shape[0]))
        print(f"kernel sort_tile {shape} int32: {ms:.4f} ms by events, device {tiers.get('device_ms')} ms, "
              f"{tiers.get('launches')} launches, torch.sort {lib:.4f} ms, bound {b:.4f} ms")
        timed[shape] = x, ms, lib, tiers, b, by
    # a float32 batch at 15,728,640 keys with signed zeros through the windows
    y = tile_keys((72, 1 << 19), torch.float32, "signed_zeros", gen)
    err = max(err, same(bitonic.sort_tile(y), bitonic.sort_tile_plain(y), "sort_tile (72, 2^19) float32 signed zeros"))
    x, ms, lib, tiers, b, by = timed[TILE_SHAPES[0]]
    plain = cuda_ms(lambda: bitonic.sort_tile_plain(x), reps=3)
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bitonic.cu",
        replaces="src/repro/kernels/bitonic.py:179", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(36, 2^20) int32", device_ms=tiers.get("device_ms"),
        launches_per_call=tiers.get("launches"),
    )


def pair_kernel_checks(gen: np.random.Generator) -> dict:
    rows = {}
    n = 1 << 19
    # K5 and K7 at every tier boundary, 1 and 3 rows, random full-range
    # keys and heavy ties (16 values), 30 % pad tags, an arange payload
    err = 0.0
    for m in PAIR_SIZES:
        for nrows in (1, 3):
            for heavy in (False, True):
                k = pair_keys((nrows, m), heavy, gen)
                t = torch.from_numpy((gen.random((nrows, m)) < 0.3).astype(np.uint8)).to(DEV)
                v = torch.arange(nrows * m, dtype=torch.int32, device=DEV).view(nrows, m)
                what = f"(rows={nrows}, n={m}){' heavy ties' if heavy else ''}"
                err = max(err, same_pairs(
                    bitonic.sort_pairs_tile_tagged(k, t, v), bitonic.sort_pairs_tile_tagged_plain(k, t, v),
                    f"sort_pairs_tile_tagged {what}",
                ), same_pairs(bitonic.sort_pairs_tile(k, v), bitonic.sort_pairs_tile_plain(k, v), f"sort_pairs_tile {what}"))
    # 8-byte keys with 8-byte payloads: one whole chunk, two, and full width
    for shape in ((3, 2048), (3, 4096), (1, n)):
        k = random_keys(shape, torch.int64, gen)
        k[:, ::7] = torch.iinfo(torch.int64).max
        v = payload(shape, torch.float64, gen)
        t = torch.from_numpy((gen.random(shape) < 0.3).astype(np.uint8)).to(DEV)
        err = max(err, same_pairs(
            bitonic.sort_pairs_tile_tagged(k, t, v), bitonic.sort_pairs_tile_tagged_plain(k, t, v),
            f"sort_pairs_tile_tagged int64/float64 {shape}",
        ), same_pairs(bitonic.sort_pairs_tile(k, v), bitonic.sort_pairs_tile_plain(k, v), f"sort_pairs_tile int64/float64 {shape}"))
    # K5 at argsort_keys' full width: (1, 2^19) int32 keys with an arange
    # payload and every tag 0 (n_valid = n).
    k = random_keys((1, n), torch.int32, gen)
    idx = torch.arange(n, dtype=torch.int32, device=DEV)[None]
    tags = torch.zeros((1, n), dtype=torch.uint8, device=DEV)
    got = bitonic.sort_pairs_tile_tagged(k, tags, idx)
    err = max(err, same_pairs(got, bitonic.sort_pairs_tile_tagged_plain(k, tags, idx), "sort_pairs_tile_tagged 2^19"))
    if not torch.equal(got[0], torch.sort(k).values) or not torch.equal(k[0, got[1][0].long()], got[0][0]):
        fail("sort_pairs_tile_tagged: keys are not torch.sort's or payloads left their keys")
    # every key dtype at 4,096 with sentinel-equal keys and a pad tail,
    # every payload width
    for name in DTYPES:
        if name == "uint32":
            continue  # reaches the kernels as int32 (repro_torch.dtypes)
        dt = TORCH_KEY[name]
        for vdt in (torch.bool, torch.float16, torch.float32, torch.float64):
            y = random_keys((4, 4096), dt, gen)
            y[:, ::5] = float("inf") if dt.is_floating_point else torch.iinfo(dt).max
            t = (torch.arange(4096, device=DEV) >= 4000).to(torch.uint8).expand(4, 4096).contiguous()
            v = payload((4, 4096), vdt, gen)
            err = max(err, same_pairs(
                bitonic.sort_pairs_tile_tagged(y, t, v), bitonic.sort_pairs_tile_tagged_plain(y, t, v),
                f"sort_pairs_tile_tagged {name}/{vdt}",
            ))
    ms = cuda_ms(lambda: bitonic.sort_pairs_tile_tagged(k, tags, idx), reps=21)
    # the event time includes the wrapper's host work; this is the card's
    tiers = launch_profile("sort_pairs_tile_tagged (1, 2^19) int32/int32",
                           lambda: bitonic.sort_pairs_tile_tagged(k, tags, idx), "pair_")
    # a one-byte payload (bool) runs an instantiation of its own
    flags = torch.from_numpy(gen.random((1, n)) < 0.5).to(DEV)
    err = max(err, same_pairs(bitonic.sort_pairs_tile_tagged(k, tags, flags),
                              bitonic.sort_pairs_tile_tagged_plain(k, tags, flags), "sort_pairs_tile_tagged int32/bool"))
    print(f"kernel sort_pairs_tile_tagged (1, 2^19) int32/bool: "
          f"{cuda_ms(lambda: bitonic.sort_pairs_tile_tagged(k, tags, flags), reps=21):.4f} ms")
    plain = cuda_ms(lambda: bitonic.sort_pairs_tile_tagged_plain(k, tags, idx), reps=3)
    lib = cuda_ms(lambda: torch.sort(k, dim=-1), reps=21)
    b, by = bound(2 * n * (4 + 4) + n, sort_comparisons([n]))
    rows["sort_pairs_tile_tagged"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bitonic.cu",
        replaces="src/repro/kernels/bitonic.py:212", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(1, 2^19) int32/int32", device_ms=tiers.get("device_ms"),
        launches_per_call=tiers.get("launches"),
    )

    # K6 at every boundary of its tiers, every key dtype and payload width
    err6, batches = 0.0, 0
    for name in ("int8", "int16", "int32", "int64", "float32"):
        for m in ROW_PAIR_SIZES:
            for vdt in (torch.bool, torch.bfloat16, torch.int32, torch.float64):
                y, ylens = row_batch(12, m, TORCH_KEY[name], gen)
                yv = payload((12, m), vdt, gen)
                err6 = max(err6, same_pairs(batched.batched_row_sort_pairs(y, yv, ylens),
                                            batched.batched_row_sort_pairs_plain(y, yv, ylens),
                                            f"batched_row_sort_pairs {name}/{vdt} (12, {m})"))
                batches += 1
    print(f"batched_row_sort_pairs: {batches} batches at every tier boundary equal the plain version bit for bit")
    # K6 at (64, 8192) int32/int32, random lengths, garbage in the pads.
    x = random_keys((64, 8192), torch.int32, gen)
    xv = random_keys((64, 8192), torch.int32, gen)
    lens = torch.from_numpy(gen.integers(0, 8193, 64).astype(np.int32)).to(DEV)
    got = batched.batched_row_sort_pairs(x, xv, lens)
    err = max(err6, same_pairs(got, batched.batched_row_sort_pairs_plain(x, xv, lens), "batched_row_sort_pairs (64, 8192)"))
    hk, hv = got[0].cpu().numpy(), got[1].cpu().numpy()
    xk, xvh = x.cpu().numpy(), xv.cpu().numpy()
    for i, ln in enumerate(lens.cpu().tolist()):
        order = np.argsort(xk[i, :ln], kind="stable")
        if not np.array_equal(hk[i, :ln], xk[i, order]) or (hv[i, ln:] != 0).any():
            fail(f"batched_row_sort_pairs row {i} is not np.sort or its pad payloads are not 0")
        if not np.array_equal(np.sort(hv[i, :ln]), np.sort(xvh[i, :ln])):
            fail(f"batched_row_sort_pairs row {i} lost payloads")
    # one row past one block's shared memory: the fill, then K5's passes
    long_k = random_keys((2, 1 << 15), torch.int32, gen)
    long_v = payload((2, 1 << 15), torch.float64, gen)
    long_lens = torch.tensor([30_000, 1 << 15], dtype=torch.int32, device=DEV)
    before = launch_counts()["sort_pairs_tile_tagged"]
    err = max(err, same_pairs(
        batched.batched_row_sort_pairs(long_k, long_v, long_lens),
        batched.batched_row_sort_pairs_plain(long_k, long_v, long_lens),
        "batched_row_sort_pairs (2, 2^15) int32/float64",
    ))
    if launch_counts()["sort_pairs_tile_tagged"] != before + 1:
        fail("a row past one block did not go through the multi-pass pair kernel")
    ms = cuda_ms(lambda: batched.batched_row_sort_pairs(x, xv, lens))
    # the event time above includes the wrapper's host work; this is the kernel's own
    profile_request("batched_row_sort_pairs (64, 8192)", lambda: batched.batched_row_sort_pairs(x, xv, lens))
    k6 = launch_profile("batched_row_sort_pairs (64, 8192) int32/int32",
                        lambda: batched.batched_row_sort_pairs(x, xv, lens), "pair_")
    print(f"kernel batched_row_sort_pairs (64, 8192) int32/int32: {ms:.4f} ms by events, device "
          f"{k6.get('device_ms')} ms, {k6.get('launches')} launches a call")
    y64 = random_keys((64, 8192), torch.int64, gen)
    v64 = payload((64, 8192), torch.float64, gen)
    err = max(err, same_pairs(batched.batched_row_sort_pairs(y64, v64, lens),
                              batched.batched_row_sort_pairs_plain(y64, v64, lens), "batched_row_sort_pairs int64/float64"))
    k6w = launch_profile("batched_row_sort_pairs (64, 8192) int64/float64",
                         lambda: batched.batched_row_sort_pairs(y64, v64, lens), "pair_")
    print(f"kernel batched_row_sort_pairs (64, 8192) int64/float64: "
          f"{cuda_ms(lambda: batched.batched_row_sort_pairs(y64, v64, lens)):.4f} ms by events, device "
          f"{k6w.get('device_ms')} ms, {k6w.get('launches')} launches a call")
    plain = cuda_ms(lambda: batched.batched_row_sort_pairs_plain(x, xv, lens), reps=3)
    lib = cuda_ms(lambda: torch.sort(x, dim=-1))
    valid = int(lens.sum())
    b, by = bound((valid + x.numel()) * (4 + 4) + 4 * 64, sort_comparisons(lens.cpu().tolist()))
    rows["batched_row_sort_pairs"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/batched.cu",
        replaces="src/repro/kernels/batched.py:181", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(64, 8192) int32/int32", device_ms=k6.get("device_ms"), launches_per_call=k6.get("launches"),
    )

    # K7 at 2^19: the untagged pair sort (its tier boundaries ran above).
    got = bitonic.sort_pairs_tile(k, idx)
    err = same_pairs(got, bitonic.sort_pairs_tile_plain(k, idx), "sort_pairs_tile 2^19")
    if not torch.equal(got[0], torch.sort(k).values) or not torch.equal(k[0, got[1][0].long()], got[0][0]):
        fail("sort_pairs_tile: keys are not torch.sort's or payloads left their keys")
    for name in ("int8", "int64", "float32"):
        y = random_keys((4, 4096), TORCH_KEY[name], gen)
        v = payload((4, 4096), torch.int16, gen)
        err = max(err, same_pairs(bitonic.sort_pairs_tile(y, v), bitonic.sort_pairs_tile_plain(y, v), f"sort_pairs_tile {name}"))
    ms = cuda_ms(lambda: bitonic.sort_pairs_tile(k, idx), reps=21)
    tiers = launch_profile("sort_pairs_tile (1, 2^19) int32/int32", lambda: bitonic.sort_pairs_tile(k, idx), "pair_")
    plain = cuda_ms(lambda: bitonic.sort_pairs_tile_plain(k, idx), reps=3)
    lib = cuda_ms(lambda: torch.sort(k, dim=-1), reps=21)
    b, by = bound(2 * n * (4 + 4), sort_comparisons([n]))
    rows["sort_pairs_tile"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bitonic.cu",
        replaces="src/repro/kernels/bitonic.py:195", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(1, 2^19) int32/int32", device_ms=tiers.get("device_ms"),
        launches_per_call=tiers.get("launches"),
    )
    return rows


# ----------------------------------------------------------------- phase 3
def request_launches(label: str, fn) -> dict:
    """Kernel launches of one request (the counts' difference across it)."""
    before = launch_counts()
    fn()
    after = launch_counts()
    got = {k: after[k] - before[k] for k in after}
    print(f"launches of one request, {label}: {got}")
    return got


def timed_sort(eng: SortEngine, x: np.ndarray, what: str, reps: int = 1) -> None:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = eng.sort(x)
        walls.append(time.perf_counter() - t0)
        if not np.array_equal(y, np.sort(x)) or y.dtype != x.dtype:
            fail(f"SortEngine.sort {what} differs from np.sort")
    r = eng.last_report
    p = r["plan"]
    wall = statistics.median(walls)
    print(
        f"sort {what}: path={p.path} method={p.method} capacity={r.get('capacity_used', p.capacity)} "
        f"retries={r['overflow_retries']} wall={wall * 1e3:.2f} ms ({x.size / wall:.4g} keys/s)"
    )


def main_path_sort() -> None:
    eng = SortEngine()
    for name in DTYPES:
        for dist in ALL_DISTRIBUTIONS:
            timed_sort(eng, make_array(dist, 100_000, seed=1, dtype=np.dtype(name)), f"{name}/{dist} n=100000")
    # below 65,536 keys skewed inputs stay on the sim path: sampled
    # splitters (local) and a large autotuned capacity (dupes)
    for name in DTYPES:
        for dist in ("local", "dupes"):
            timed_sort(eng, make_array(dist, 60_000, seed=1, dtype=np.dtype(name)), f"{name}/{dist} n=60000")
    # a forced small capacity overflows and escalates x2 until it fits
    dupes = make_array("dupes", 60_000, seed=7)
    forced = SortPlan("sim", "paper", 512, 65536, "forced small capacity")
    t0 = time.perf_counter()
    if not np.array_equal(eng.sort(dupes, plan=forced), np.sort(dupes)):
        fail("SortEngine.sort with a forced small capacity differs from np.sort")
    r = eng.last_report
    if r["overflow_retries"] == 0:
        fail("a forced capacity of 512 for 60,000 dupes did not overflow")
    print(
        f"sort int32/dupes n=60000 forced capacity 512: retries={r['overflow_retries']} "
        f"capacity_used={r['capacity_used']} wall={(time.perf_counter() - t0) * 1e3:.2f} ms"
    )
    # int64 keys spanning the whole type: the exact unsigned bucket rule
    gen = np.random.default_rng(3)
    wide = gen.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 100_000, dtype=np.int64, endpoint=True)
    timed_sort(eng, wide, "int64 full-span n=100000")
    paper = SortEngine(host_threshold=1 << 25)
    for n in (1 << 22, PAPER_MAX_KEYS):
        timed_sort(paper, make_array("random", n, seed=2), f"paper int32 random n={n}", reps=3)
    paper144 = SortEngine(OHHCTopology(2, "full"), host_threshold=1 << 25)
    timed_sort(paper144, make_array("random", 1 << 22, seed=4), "P=144 int32 random n=4194304", reps=3)
    for n in (1 << 22, PAPER_MAX_KEYS):
        x = make_array("random", n, seed=2)
        got = request_launches(f"SortEngine.sort int32 n={n}", lambda x=x: paper.sort(x))
        runs = 1 + paper.last_report["overflow_retries"]  # a retry runs the request again
        # K3: one call (the even half-pass over two tiles a row) at 15.7M keys
        for name, want in (("bucket_count_rank", runs), ("sort_tile", runs),
                           ("merge_tiles", runs if n == PAPER_MAX_KEYS else 0)):
            if got[name] != want:
                fail(f"one sort of {n} keys launched {name} {got[name]} times in {runs} runs, not {want}")
        profile_request(f"SortEngine.sort int32 n={n}", lambda x=x: paper.sort(x))


def profile_request(label: str, fn) -> "float | None":
    """Device time by kernel and copy for one warm request, beside its wall
    time (``repro_torch.devtrace``: only events on the card count)."""
    fn()  # warm
    torch.cuda.synchronize()
    walls = []

    def timed_request():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    calls = devtrace.call_events(timed_request, 1)
    wall = walls[0]
    if not calls or not calls[0]:
        print(f"profile {label}: wall {wall * 1e3:.3f} ms, device time not visible to torch.profiler")
        return None
    by_name: dict[str, list] = {}
    for name, ms in calls[0]:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += ms
        row[1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    print(
        f"profile {label}: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / (wall * 1e3):.1f}% of wall)"
    )
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms  x{count:<4d} {name[:90]}")
    return busy


# ----------------------------------------------------------------- phase 4
def main_path_segments() -> None:
    gen = np.random.default_rng(5)
    eng = SortEngine()
    for name in ("int32", "float32"):
        lens = gen.integers(1000, 8193, 64)
        keys = make_array("random", int(lens.sum()), seed=6, dtype=np.dtype(name))
        segs = np.split(keys, np.cumsum(lens)[:-1])
        for forced in ("pallas", "pallas2op", None):
            if forced is None:
                os.environ.pop("REPRO_ROW_BACKEND", None)
            else:
                os.environ["REPRO_ROW_BACKEND"] = forced
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = eng.sort_segments(keys, lens)
                walls.append(time.perf_counter() - t0)
                for o, s in zip(out, segs):
                    if not np.array_equal(o, np.sort(s)):
                        fail(f"sort_segments {name} backend={forced} differs from np.sort")
            wall = statistics.median(walls)
            plan = eng.last_report["plan"]
            print(
                f"sort_segments {name} 64 x <=8192 backend={forced or 'unforced'}: method={plan.method} "
                f"wall={wall * 1e3:.2f} ms ({keys.size / wall:.4g} keys/s); {plan.reason}"
            )
            if forced is None:
                got = request_launches(
                    f"sort_segments {name} 64 x <=8192", lambda: eng.sort_segments(keys, lens)
                )
                if got["batched_row_sort"] != 1:
                    fail(f"one sort_segments request launched the row kernel {got['batched_row_sort']} times")
                profile_request(f"sort_segments {name} 64 x <=8192", lambda: eng.sort_segments(keys, lens))
    os.environ.pop("REPRO_ROW_BACKEND", None)


def long_segments() -> None:
    """Rows above the row kernel's 8,192 keys take the bucket path: one
    count/rank, one local sort and one gather for the whole batch."""
    gen = np.random.default_rng(8)
    eng = SortEngine()
    for name in ("int32", "float32"):
        lens = gen.integers(9000, 65537, 64)
        keys = make_array("random", int(lens.sum()), seed=9, dtype=np.dtype(name))
        segs = np.split(keys, np.cumsum(lens)[:-1])
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.sort_segments(keys, lens)
            walls.append(time.perf_counter() - t0)
            for o, s in zip(out, segs):
                if not np.array_equal(o, np.sort(s)):
                    fail(f"sort_segments {name} 64 x 9,000-65,536 differs from np.sort")
        wall = statistics.median(walls)
        r = eng.last_report
        print(
            f"sort_segments {name} 64 x 9,000-65,536: method={r['plan'].method} "
            f"capacity={r['plan'].capacity} retries={r['overflow_retries']} "
            f"wall={wall * 1e3:.2f} ms ({keys.size / wall:.4g} keys/s)"
        )
        t0 = time.perf_counter()
        eng.plan_segments(keys, lens)
        print(f"  of which plan_segments alone (packing and host stats): {(time.perf_counter() - t0) * 1e3:.2f} ms")
        got = request_launches(
            f"sort_segments {name} 64 x 9,000-65,536", lambda: eng.sort_segments(keys, lens)
        )
        runs = 1 + eng.last_report["overflow_retries"]
        if got["bucket_count_rank"] != runs or got["sort_tile"] != runs or got["batched_row_sort"]:
            fail("long segments did not share one count/rank and one tile sort launch per run")
        if name == "int32":
            profile_request(f"sort_segments {name} 64 x 9,000-65,536", lambda: eng.sort_segments(keys, lens))


# ----------------------------------------------------------------- phase 5
def timed(label: str, fn, check, reps: int = 3):
    """Warm median wall time of ``fn`` (the first call outside the clock),
    each result checked by ``check``."""
    check(fn())
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(out)
    wall = statistics.median(walls)
    print(f"{label}: wall={wall * 1e3:.3f} ms")
    return wall


def held_to_numpy(keys: np.ndarray, ks: np.ndarray, perm: np.ndarray, what: str, leaves=()) -> None:
    """Keys equal np.sort, keys[perm] equals them, perm is a permutation,
    and every payload leaf stays with its key."""
    if not np.array_equal(ks, np.sort(keys)) or not np.array_equal(keys[perm], ks):
        fail(f"{what}: keys differ from np.sort or keys[perm] differs from them")
    if not np.array_equal(np.sort(perm), np.arange(keys.size)):
        fail(f"{what}: the permutation is not one")
    for src, got in leaves:
        if np.asarray(got).tobytes() != src[perm].tobytes():
            fail(f"{what}: a payload leaf left its key")


def pairs_path() -> None:
    eng = SortEngine()
    gen = np.random.default_rng(11)

    def flat_check(keys, what):
        def check(out):
            ks, vs = out
            held_to_numpy(keys, ks.cpu().numpy(), vs.cpu().numpy().astype(np.int64), what)
        return check

    # ServeEngine.order_by_length: (prompt length, request index) of a batch
    lens = gen.integers(1, 4097, 256).astype(np.int32)
    idx = np.arange(256, dtype=np.int32)
    timed("sort_pairs flat, 256 request lengths", lambda: eng.sort_pairs(lens, idx), flat_check(lens, "sort_pairs 256"), reps=20)
    got = request_launches("sort_pairs flat 256", lambda: eng.sort_pairs(lens, idx))
    if got["sort_pairs_tile_tagged"] != 1 or sum(got.values()) != 1:
        fail("one flat sort_pairs request did not launch the tagged pair kernel exactly once")
    n = ops.MAX_TILE
    keys = make_array("random", n, seed=12)
    pidx = np.arange(n, dtype=np.int32)
    timed("sort_pairs flat, 2^19 int32 pairs", lambda: eng.sort_pairs(keys, pidx), flat_check(keys, "sort_pairs 2^19"))
    for dtype in ("int32", "int64"):
        if dtype == "int64":
            x = gen.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64, endpoint=True)
        else:
            x = keys

        def check(out, x=x, dtype=dtype):
            held_to_numpy(x, out[0], out[1], f"argsort_keys {dtype} 2^19")

        timed(f"argsort_keys 2^19 {dtype}", lambda x=x: eng.argsort_keys(x), check)
        if eng.last_report["plan"].path != "sim":
            fail(f"argsort_keys {dtype} at 2^19 left the pair kernel: {eng.last_report['plan']}")
        got = request_launches(f"argsort_keys 2^19 {dtype}", lambda x=x: eng.argsort_keys(x))
        if got["sort_pairs_tile_tagged"] != 1 or sum(got.values()) != 1:
            fail(f"one argsort_keys {dtype} request did not launch the tagged pair kernel exactly once")
    profile_request("argsort_keys 2^19 int32", lambda: eng.argsort_keys(keys))
    for m in (4096, n):
        k = keys[:m]
        flat = np.arange(m, dtype=np.int32)
        tree = {
            "idx": np.arange(m, dtype=np.int64),
            "nested": (k.astype(np.float64), (flat % 251).astype(np.int8)),
        }

        def check(out, k=k, tree=tree, m=m):
            ks, o = out
            held_to_numpy(k, ks, o["idx"], f"sort_pairs pytree {m}", [
                (tree["idx"], o["idx"]), (tree["nested"][0], o["nested"][0]),
                (tree["nested"][1], o["nested"][1]),
            ])

        timed(f"sort_pairs pytree of 3 leaves, {m} keys", lambda k=k, tree=tree: eng.sort_pairs(k, tree), check)
        got = request_launches(f"sort_pairs pytree {m}", lambda k=k, tree=tree: eng.sort_pairs(k, tree))
        if got["sort_pairs_tile_tagged"] != 1:
            fail("one pytree sort_pairs request did not launch the tagged pair kernel once")


# ----------------------------------------------------------------- phase 6
def workloads_path() -> None:
    eng = SortEngine(host_threshold=1 << 25)
    x = make_array("random", PAPER_MAX_KEYS, seed=13)
    want = np.sort(x)
    for k in (PAPER_MAX_KEYS // 2, 1000):
        def check(out, k=k):
            if not np.array_equal(out, want[:k]) or out.dtype != x.dtype:
                fail(f"top_k k={k} differs from np.sort(x)[:k]")

        timed(f"top_k n={PAPER_MAX_KEYS} k={k}", lambda k=k: eng.top_k(x, k), check)
        r = eng.last_report
        p = r["plan"]
        print(
            f"  plan path={p.path} capacity={r.get('capacity_used', p.capacity)} "
            f"retries={r['overflow_retries']} skipped={r['skipped_buckets']}; {p.reason}"
        )
        want_path = "sim" if k > PAPER_MAX_KEYS // 4 else "host"
        if p.path != want_path:
            fail(f"top_k k={k} planned {p.path}, not {want_path}")
        got = request_launches(f"top_k n={PAPER_MAX_KEYS} k={k}", lambda k=k: eng.top_k(x, k))
        runs = 1 + eng.last_report["overflow_retries"]
        if want_path == "sim" and (got["bucket_count_rank"] != runs or got["sort_tile"] != runs):
            fail("one top_k request on the sim path did not launch K1 and K2 once a run")
        if want_path == "host" and sum(got.values()):
            fail("the host head launched a kernel")
    profile_request(f"top_k n={PAPER_MAX_KEYS} k={PAPER_MAX_KEYS // 2}", lambda: eng.top_k(x, PAPER_MAX_KEYS // 2))
    buf = np.sort(make_array("random", 1 << 22, seed=14))
    new = make_array("random", 1 << 20, seed=15)
    merged = np.sort(np.concatenate([buf, new]))

    def check(out):
        if not np.array_equal(out, merged):
            fail("merge_sorted differs from np.sort of the union")

    timed("merge_sorted 2^20 new keys into a sorted 2^22 buffer", lambda: eng.merge_sorted(buf, new), check)
    print(f"  {eng.last_report['plan'].reason}")
    request_launches("merge_sorted 2^20 into 2^22", lambda: eng.merge_sorted(buf, new))


# ----------------------------------------------------------------- phase 7
SERVE_REQUESTS, SERVE_CLIENTS = 600, 8  # the reference sortd benchmark at --paper
FAULT_REQUESTS = 100
FLEET_REQUESTS, FLEET_WARM = 800, 60  # the reference fleet benchmark at --paper
PHASE7_KERNELS = ("batched_row_sort", "bucket_count_rank", "sort_tile")


def serving_mix(n_req: int, dtype: str, seed: int, *, max_bucket: int = 1 << 12, tail: float = 0.0) -> list:
    """The reference sortd benchmark's request stream: 2 % oversize
    (max_bucket + 1 to 2 max_bucket - 1 keys), 48 % of 64-511 keys, 35 % of
    512-2,047 and 15 % of 2,048-4,095.  With ``tail``, that share of the
    requests has 8,193-32,768 keys instead: rows past the row kernel's
    8,192 keys, which a flush sorts on the bucket path."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_req):
        if tail and rng.random() < tail:
            n = int(rng.integers(8193, 32769))
        else:
            r = rng.random()
            if r < 0.02:
                n = int(rng.integers(max_bucket + 1, max_bucket * 2))
            elif r < 0.50:
                n = int(rng.integers(64, 512))
            elif r < 0.85:
                n = int(rng.integers(512, 2048))
            else:
                n = int(rng.integers(2048, 4096))
        out.append(rng.integers(0, 1 << 30, n).astype(dtype))
    return out


def exact(reqs, outs, what: str) -> None:
    for x, o in zip(reqs, outs):
        if o.dtype != x.dtype or not np.array_equal(o, np.sort(x)):
            fail(f"{what}: a result differs from np.sort")


def record_flushes(eng: SortEngine) -> list:
    """Wrap ``eng.sort_segments`` (a ``Sortd`` flush) to keep each flush's
    plan, key count and dtype."""
    plans = []
    inner = eng.sort_segments

    def sort_segments(keys, seg_lens, **kw):
        out = inner(keys, seg_lens, **kw)
        plans.append((eng.last_report["plan"], int(np.sum(seg_lens)), np.asarray(keys).dtype))
        return out

    eng.sort_segments = sort_segments
    return plans


def serving_stats(m: dict, wall: float, n_req: int) -> str:
    rows = sum(b["requests"] for k, b in m["buckets"].items() if not k.endswith("/direct"))
    batches = sum(b["batches"] for k, b in m["buckets"].items() if not k.endswith("/direct"))
    methods = collections.Counter()
    for b in m["buckets"].values():
        methods.update(b["methods"])
    return (
        f"p50 {m['latency_ms']['p50']:.3f} ms, p99 {m['latency_ms']['p99']:.3f} ms, "
        f"{n_req / wall:.1f} requests/s, mean batch {rows / max(batches, 1):.2f}, "
        f"flushes {m['flushes']}, direct {m['oversize_direct']}, flush methods {dict(methods)}"
    )


def busy_share(label: str, fn) -> None:
    """The card's busy share over one run of ``fn``: the device time of
    every kernel and copy it ran (``devtrace``) over its wall time."""
    walls = []

    def timed_run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    calls = devtrace.call_events(timed_run, 1)
    if not calls or not calls[0]:
        print(f"busy {label}: device time not visible to torch.profiler")
        return
    busy = sum(ms for _, ms in calls[0])
    print(f"busy {label}: card busy {busy:.3f} ms of {walls[0] * 1e3:.3f} ms wall "
          f"({100 * busy / (walls[0] * 1e3):.2f}%), {len(calls[0])} device events")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for name, ms in calls[0]:
        by_name[name][0] += ms
        by_name[name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    print("  top device time: " + "; ".join(f"{name[:70]} {ms:.3f} ms ({n})" for name, (ms, n) in top))


def sortd_run(cfg: SortdConfig, reqs: list, label: str) -> dict:
    """One closed-loop run of ``reqs`` through ``Sortd`` over a fresh
    ``SortEngine()``, warmed on a throwaway service first (as the
    reference benchmark warms), then the same run under the profiler for
    the card's busy share.  Returns the measured run's launches."""
    eng = SortEngine()
    with Sortd(eng, cfg) as warm:
        for x in reqs[:20]:
            warm.sort(x)
    reset_launches()
    with Sortd(eng, cfg) as sd:
        wall, outs = drive_closed_loop(sd.submit, reqs, clients=SERVE_CLIENTS)
        m = sd.metrics()
    counts = launch_counts()
    exact(reqs, outs, f"Sortd {label}")
    if m["completed"] != len(reqs) or m["failed"]:
        fail(f"Sortd {label}: {m['completed']} completed, {m['failed']} failed of {len(reqs)}")
    print(f"sortd {label}: {serving_stats(m, wall, len(reqs))}, wall {wall * 1e3:.1f} ms")
    print(f"  launches: {counts}")
    with Sortd(eng, cfg) as sd:
        busy_share(f"sortd {label}", lambda: exact(reqs, drive_closed_loop(sd.submit, reqs, clients=SERVE_CLIENTS)[1], label))
    return counts


def merge_ticks() -> dict:
    """16 ``submit_merge`` ticks of 2,048 keys into a buffer that starts
    at 16,384 keys and grows by each tick."""
    rng = np.random.default_rng(70)
    buf = np.sort(rng.integers(0, 1 << 30, 16384).astype(np.int32))
    reset_launches()
    walls = []
    with Sortd(SortEngine()) as sd:
        for _ in range(16):
            new = rng.integers(0, 1 << 30, 2048).astype(np.int32)
            t0 = time.perf_counter()
            out = sd.submit_merge(buf, new).result(timeout=120)
            walls.append(time.perf_counter() - t0)
            if not np.array_equal(out, np.sort(np.concatenate([buf, new]))):
                fail("Sortd.submit_merge differs from np.sort of the union")
            buf = out
        m = sd.metrics()
    counts = launch_counts()
    print(f"sortd merge: 16 ticks of 2048 into 16384..{buf.size - 2048} keys, median wall "
          f"{statistics.median(walls) * 1e3:.3f} ms, buckets {sorted(m['buckets'])}; launches {counts}")
    return counts


def fault_ladder() -> dict:
    """The five scenarios of the reference fault benchmark at d_h = 1,
    then healed, each serving ``FAULT_REQUESTS`` requests of the mix."""
    topo = OHHCTopology(1, "full")
    scenarios = [
        FaultScenario.optical_link_down(1),
        FaultScenario.random_links(topo, 2, seed=3),
        FaultScenario.random_links(topo, 4, seed=3),
        FaultScenario.group_uplinks_down(topo, 1),
        FaultScenario.worker_down(1),
        None,
    ]
    impossible = {"uplinks_g1_down", "worker1_down"}
    eng = SortEngine(topo)
    plans = record_flushes(eng)
    total = collections.Counter()
    cfg = SortdConfig(max_batch=64, max_wait_s=0.005, max_bucket=1 << 12)
    with Sortd(eng, cfg) as sd:
        for i, sc in enumerate(scenarios):
            name = sc.name if sc is not None else "healed"
            reqs = serving_mix(FAULT_REQUESTS, "int32", seed=40 + i)
            sd.set_fault_scenario(sc)
            m0 = sd.metrics()
            plans.clear()
            reset_launches()
            wall, outs = drive_closed_loop(sd.submit, reqs, clients=SERVE_CLIENTS)
            counts = launch_counts()
            m1 = sd.metrics()
            exact(reqs, outs, f"Sortd under {name}")
            flushes = sum(m1["flushes"].values()) - sum(m0["flushes"].values())
            degraded = m1["degraded_flushes"] - m0["degraded_flushes"]
            if len(plans) != flushes or not flushes:
                fail(f"{name}: {len(plans)} flush plans recorded for {flushes} flushes")
            slowdowns = sorted({p.fault_slowdown for p, _, _ in plans if p.fault_slowdown is not None})
            if sc is None:
                if degraded or any(p.fault is not None for p, _, _ in plans) or not counts["batched_row_sort"]:
                    fail("the healed service still served degraded flushes, or launched no row kernel")
            elif name in impossible:
                if any(p.path != "host" or p.fault != name for p, _, _ in plans) or degraded != flushes:
                    fail(f"{name}: a flush left the host fallback")
                if sum(counts.values()):
                    fail(f"{name}: the host fallback launched kernels {counts}")
            else:
                if degraded != flushes or any(p.fault != name or p.fault_slowdown is None for p, _, _ in plans):
                    fail(f"{name}: a flush plan lacks its fault or slowdown")
                if not counts["batched_row_sort"]:
                    fail(f"{name}: the degraded service launched no row kernel")
                cpu = SortEngine(topo, device="cpu", fault_scenario=sc)
                for p, n, dtype in plans:
                    if cpu.plan(np.zeros(n, dtype)).fault_slowdown != p.fault_slowdown:
                        fail(f"{name}: the card's flush slowdown {p.fault_slowdown} differs from the CPU's")
            print(f"fault {name}: {flushes} flushes ({degraded} degraded), paths "
                  f"{sorted({p.path for p, _, _ in plans})}, slowdowns {slowdowns}, "
                  f"{len(reqs) / wall:.1f} requests/s, wall {wall * 1e3:.1f} ms; launches {counts}")
            total.update(counts)
    return dict(total)


def fleet_path() -> dict:
    """``SortdFleet`` of four workers on the one card, each with its own
    ``SortEngine()``: 800 requests of ``loadgen.request_mix`` from 8
    clients after 60 warm ones, healthy and then with the busiest worker
    killed after 60 + 800 // 3 admissions."""
    warm = request_mix(FLEET_WARM, dtype="int32", seed=3)
    reqs = request_mix(FLEET_REQUESTS, dtype="int32", seed=11)
    # the kernels were built in phase 1; warm the row backends' probes on a
    # throwaway service before any worker's heartbeat starts
    with Sortd(SortEngine()) as w:
        for x in warm[:20]:
            w.sort(x)
    reset_launches()
    reports = {}
    for label, chaos in (
        ("healthy", None),
        ("chaos", ChaosConfig(name="kill-busiest-midload", kill_worker_after=FLEET_WARM + FLEET_REQUESTS // 3)),
    ):
        with SortdFleet(FleetConfig(workers=4), chaos=chaos) as fleet:
            drive_closed_loop(fleet.submit, warm, clients=SERVE_CLIENTS)
            wall, outs = drive_closed_loop(fleet.submit, reqs, clients=SERVE_CLIENTS)
            rep = fleet.report()
        exact(reqs, outs, f"SortdFleet {label}")
        f = rep["fleet"]
        methods = collections.Counter()
        for w in rep["workers"].values():
            for b in w["sortd"]["buckets"].values():
                methods.update(b["methods"])
        print(f"fleet {label}: flush methods {dict(methods)}")
        print(f"fleet {label}: {FLEET_REQUESTS / wall:.1f} requests/s, p50 {f['latency_ms']['p50']:.3f} ms, "
              f"p99 {f['latency_ms']['p99']:.3f} ms, steals {f['steals']}, failovers {f['failovers']}, "
              f"readmitted {f['readmitted']}, live {f['live_workers']}, wall {wall * 1e3:.1f} ms")
        reports[label] = rep
    if reports["healthy"]["fleet"]["failovers"]:
        fail("the healthy fleet failed a worker over")
    chaos = reports["chaos"]
    if chaos["fleet"]["failovers"] < 1 or chaos["chaos"]["killed_worker"] is None:
        fail("the chaos run killed no worker or failed none over")
    print(f"  chaos killed worker {chaos['chaos']['killed_worker']} ({chaos['chaos'].get('fault_scenario')})")
    counts = launch_counts()
    print(f"  launches over both fleet runs: {counts}")
    return counts


def serving_path() -> dict:
    total = collections.Counter()
    bench_cfg = SortdConfig(max_batch=64, max_wait_s=0.005, max_bucket=1 << 12)
    for dtype in ("int32", "float32"):
        total.update(sortd_run(bench_cfg, serving_mix(SERVE_REQUESTS, dtype, 11), f"{dtype} bench config"))
        total.update(sortd_run(SortdConfig(), serving_mix(SERVE_REQUESTS, dtype, 12, tail=0.15),
                               f"{dtype} default config, 15% of 8193-32768 keys"))
    total.update(merge_ticks())
    for name in PHASE7_KERNELS:
        if not total[name]:
            fail(f"{name} never launched on the Sortd path")
    total.update(fault_ladder())
    total.update(fleet_path())
    return dict(total)


# ----------------------------------------------------------------- phase 8
PHASE8_KERNELS = ("bucket_count_rank", "sort_tile", "merge_tiles", "batched_row_sort", "sort_pairs_tile_tagged")
# The paper's sizes (PERF.md section 4): 2^22 keys and 15,728,640 (60 MB
# of int32, its largest array).
PAPER_GRID_SIZES = (1 << 22, PAPER_MAX_KEYS)


def verify_cli_run(mode: str, *extra: str) -> tuple[dict, dict]:
    """``python -m repro_torch.verify --<mode>`` on the card, in process;
    its JSON report and its launches.  Fails unless it
    exits 0: no failing cell, cross-check mismatch, failing property or
    drift."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "report.json"
        reset_launches()
        t0 = time.perf_counter()
        rc = verify_cli.main([f"--{mode}", "--device", "cuda", "-q", "--report", str(path), *extra])
        secs = time.perf_counter() - t0
        counts = launch_counts()
        report = json.loads(path.read_text())
    if rc != 0:
        fail(f"python -m repro_torch.verify --{mode} on the card exited {rc}")
    print(f"verify --{mode}: {report['scenario_count']} cells, {len(report['property_checks'])} property checks, "
          f"{secs:.1f} s; launches {counts}")
    return report, counts


def paper_scale_grid() -> dict:
    """The paper's sizes through ``run_grid``: every row oracle-checked,
    the paths of one input cross-checked, with each row's seconds,
    capacity, retries and dense ``(P, capacity)`` buffer."""
    cells = [
        grid.Scenario(path, method, "int32", dist, n, 1)
        for n in PAPER_GRID_SIZES
        for dist in ("random", "dupes", "sorted", "local")
        for path, method in (("sim", "paper"), ("sim", "sampled"), ("host", "paper"))
    ]
    cells += [grid.Scenario("sim", "paper", "int32", "random", PAPER_GRID_SIZES[0], d_h) for d_h in (2, 3)]
    largest = (0, None)
    merges_at_largest = 0

    def progress(r):
        nonlocal last, largest, merges_at_largest
        now = launch_counts()
        got = {k: now[k] - last[k] for k in now if now[k] != last[k]}
        last = now
        if r.scenario.n == PAPER_GRID_SIZES[-1]:
            merges_at_largest += got.get("merge_tiles", 0)
        P = OHHCTopology(r.scenario.d_h, r.scenario.variant).total_procs
        dense = P * r.capacity * 4 if r.path == "sim" and r.capacity else 0
        largest = max(largest, (dense, r.scenario_id))
        print(f"paper {r.scenario_id}: {r.status}{' ' + r.detail if r.detail else ''}, {r.elapsed_s:.3f} s, path={r.path} "
              f"capacity={r.capacity} retries={r.retries} dense buffer {dense / 2**20:.1f} MiB; launches {got}")

    reset_launches()
    last = launch_counts()
    t0 = time.perf_counter()
    results = differential.run_grid(cells, progress=progress, engines=differential.EngineCache())
    fails = [f"{r.scenario_id}: {r.detail}" for r in results if r.status != "pass"]
    mismatches = cross_check(results)
    del results
    eng = SortEngine(host_threshold=1 << 25)  # 4,194,304 keys stay on the kernels
    x = make_array("random", PAPER_GRID_SIZES[0], seed=7)
    props = metamorphic_checks(eng, x, subject=f"int32/random/n{x.size}") + fault_replay_for_engine_run(eng, x)
    if eng.last_report["plan"].path != "sim":
        fail(f"the paper-scale property run left the kernels: {eng.last_report['plan']}")
    bad = [f"{p.check}[{p.subject}]: {p.detail}" for p in props if p.status != "pass"]
    counts = launch_counts()
    print(f"paper scale: {len(cells)} rows, {len(mismatches)} cross-check mismatches, "
          f"{len(props) - len(bad)}/{len(props)} property checks pass, {time.perf_counter() - t0:.1f} s; "
          f"largest dense buffer {largest[0] / 2**30:.3f} GiB ({largest[1]}); launches {counts}")
    if fails or mismatches or bad:
        fail(f"paper scale: failing rows {fails}, mismatches {mismatches}, properties {bad}")
    if not merges_at_largest:
        fail(f"no sim row of {PAPER_GRID_SIZES[-1]} keys reached the tile merge")
    return counts


def conformance() -> dict:
    t0 = time.perf_counter()
    total = collections.Counter()
    report, counts = verify_cli_run("smoke")
    if report["scenario_count"] != 438 or report["drift"] is None or not report["drift"]["clean"]:
        fail(f"the smoke run held {report['scenario_count']} cells or was not gated clean: {report['drift']}")
    total.update(counts)
    # the impossible fault classes take the host fallback and launch nothing
    cells = [c for c in grid.fault_grid() if c.fault in grid.FAULT_IMPOSSIBLE]
    reset_launches()
    results = differential.run_fault_grid(cells, engines=differential.EngineCache())
    if any(r.status != "pass" or r.path != "host" for r in results) or sum(launch_counts().values()):
        fail(f"an impossible fault cell failed, left the host or launched a kernel: {launch_counts()}")
    print(f"verify: {len(cells)} fault cells of {grid.FAULT_IMPOSSIBLE} on the host fallback, no launch")
    report, counts = verify_cli_run("full", "--skip-properties")
    if report["scenario_count"] != 1560 + 66 + 30 + 90:
        fail(f"the full run held {report['scenario_count']} cells")
    wide = [sid for sid, rec in report["baseline"]["scenarios"].items()
            if sid.startswith("sim/") and "/int64/" in sid and rec["path"] == "sim"]
    if len(wide) != 130:
        fail(f"{len(wide)} int64 sim cells ran on the sim path, not 130")
    total.update(counts)
    total.update(paper_scale_grid())
    for name in PHASE8_KERNELS:
        if not total[name]:
            fail(f"{name} never launched in phase 8")
    print(f"phase 8 (conformance): {time.perf_counter() - t0:.1f} s; launches {dict(total)}")
    return dict(total)


# ----------------------------------------------------------------- phase 12
# The reference CLI's --warmup 2 and 5 repeats for every suite; the
# paper-scale case at warmup 1 and 3 repeats (each call 15.7M keys).
PERF_WARMUP, PERF_REPEATS = 2, 5
PAPER_CASE_WARMUP, PAPER_CASE_REPEATS = 1, 3
PERF_SUITE_KERNELS = ("bucket_count_rank", "sort_tile", "batched_row_sort", "sort_pairs_tile_tagged")
UNCALLED_KERNELS = ("batched_row_sort_pairs", "sort_pairs_tile")  # K6, K7: no caller in either package
CALIBRATED_PCT_MAX, SHEET_PCT_MAX = 105.0, 100.0


def perf_line(rec) -> None:
    pct = "-" if rec.pct_of_roofline is None else f"{rec.pct_of_roofline:.6g} %"
    print(f"  {rec.case_id}: median {rec.median_s * 1e3:.4f} ms, iqr {rec.iqr_s * 1e3:.4f} ms, "
          f"norm_ratio {rec.norm_ratio:.6g}, pct_of_roofline {pct}", flush=True)


def roofline_checks(records) -> None:
    """No call beats the card's peaks: a normalised case above 105 % of the
    calibrated roofline, or above 100 % of the data sheet's, is a
    measurement fault (a sample that ended before the card did, or a
    calibration that read L2)."""
    for rec in records:
        if not (math.isfinite(rec.median_s) and rec.median_s > 0):
            fail(f"perf case {rec.case_id}: raw_s {rec.median_s}")
        if not rec.normalized:
            continue
        sheet = perf.normalize(rec.median_s, rec.workload, H100)["pct_of_roofline"]
        if not rec.pct_of_roofline <= CALIBRATED_PCT_MAX or not sheet <= SHEET_PCT_MAX:
            fail(f"perf case {rec.case_id}: {rec.pct_of_roofline} % of the calibrated roofline, "
                 f"{sheet} % of the data sheet's")


def paper_case(hw):
    """The paper's largest array through ``run_case``: ``SortEngine.sort``
    of 15,728,640 random int32 keys at phase 3's ``host_threshold`` (at
    the default 2^20 it would take the host path and launch nothing),
    checked against ``np.sort`` outside the clock."""
    state = {}

    def setup():
        eng = SortEngine(host_threshold=1 << 25, device=DEV.type)
        x = make_array("random", PAPER_MAX_KEYS, seed=PAPER_MAX_KEYS)
        state.update(eng=eng, x=x)
        eng.sort(x)
        return lambda: eng.sort(x)

    case = perf.PerfCase(
        suite="engine", key=f"sort/random/{PAPER_MAX_KEYS}/int32", setup=setup,
        workload=perf_suites._sort_workload(PAPER_MAX_KEYS, 4),
    )
    rec = perf.run_case(case, hw=hw, warmup=PAPER_CASE_WARMUP, repeats=PAPER_CASE_REPEATS, device=DEV.type)
    counts = launch_counts()
    eng, x = state["eng"], state["x"]
    if eng.last_report["plan"].path != "sim":
        fail(f"the paper-scale perf case left the kernels: {eng.last_report['plan']}")
    if not np.array_equal(eng.sort(x), np.sort(x)):
        fail("the paper-scale perf case differs from np.sort")
    perf_line(rec)
    roofline_checks([rec])
    return rec, counts


def verdict_lines(verdicts) -> None:
    for v in verdicts:
        rel = "-" if v.rel is None else f"{v.rel:.4f}x"
        print(f"    {v.status:7s} {v.case_id}: {rel} {v.detail}")


def perf_gate() -> dict:
    """Phase 12: the port's perf gate (``repro_torch.perf``) whole on the
    card; runs after phase 8, before the model phases.  Returns the
    launches of (a) and (b)."""
    t0 = time.perf_counter()
    dev = DEV.type
    hw = perf.host_hw(dev)
    label = perf_cli.hw_label(hw, dev)
    print(f"perf gate on {label}: calibrated {hw.name}: copy {hw.hbm_bw:.6g} B/s, float32 GEMM "
          f"{hw.peak_bf16_flops:.6g} FLOP/s; data sheet ({H100.name}): HBM {H100.hbm_bw:.6g} B/s, "
          f"float32 {PEAK_OPS_S:.6g}, bf16 {H100.peak_bf16_flops:.6g} FLOP/s")

    # (a) every suite at full scope
    reset_launches()
    records = {}
    for suite in perf_suites.SUITE_NAMES:
        ts = time.perf_counter()
        records[suite] = perf.run_suite(suite, smoke=False, hw=hw, warmup=PERF_WARMUP, repeats=PERF_REPEATS,
                                        progress=perf_line, device=dev)
        roofline_checks(records[suite])
        print(f"  suite {suite}: {len(records[suite])} cases, {time.perf_counter() - ts:.1f} s")
    suite_counts = launch_counts()
    print(f"perf gate (a): {sum(map(len, records.values()))} cases in {len(records)} suites; launches {suite_counts}")

    # (b) the paper's largest array
    reset_launches()
    _, paper_counts = paper_case(hw)
    print(f"perf gate (b): launches {paper_counts}")

    # (c) the gate end to end: (a) recorded, a second run of two suites
    # judged against it by the CLI; (a) against the committed baselines
    with tempfile.TemporaryDirectory() as tmp:
        for suite, recs in records.items():
            doc = perf.build_baseline(recs, suite=suite, hw_name=label)
            perf.save_baseline(doc, perf.baseline_path(suite, tmp))
        report = Path(tmp) / "report.json"
        reset_launches()
        rc = perf_cli.main(["--full", "--suite", "engine", "--suite", "kernels", "--device", dev,
                            "--baseline-dir", tmp, "--slack", "2", "--report", str(report), "-q"])
        gate_counts = launch_counts()
        rep = json.loads(report.read_text())
    print(f"perf gate (c): the CLI re-ran engine and kernels against (a) with --slack 2: exit {rc}, "
          f"{rep['totals']}; launches {gate_counts}")
    structural = []
    for suite, body in rep["suites"].items():
        verdicts = [perf.CaseVerdict(**v) for v in body["verdicts"]]
        verdict_lines(verdicts)
        structural += [v.case_id for v in verdicts if v.status in ("new", "missing")]
    for suite, recs in records.items():
        path = perf.baseline_path(suite, perf_cli.DEFAULT_BASELINE_DIR)
        if not path.exists():
            fail(f"no committed port baseline {path}")
        verdicts = perf.judge(recs, perf.load_baseline(path))
        print(f"  (a) against the committed {path.name}: {perf.summarize(verdicts)} (timing printed, not gated)")
        verdict_lines([v for v in verdicts if v.status != "pass"])
        structural += [v.case_id for v in verdicts if v.status in ("new", "missing")]
    if structural:
        fail(f"perf cases new to or missing from a baseline: {structural}")

    # (d) kernel launches
    for name in PERF_SUITE_KERNELS:
        if not suite_counts[name]:
            fail(f"{name} never launched in the perf suites")
    if not paper_counts["merge_tiles"]:
        fail("merge_tiles never launched in the paper-scale perf case")
    for name in UNCALLED_KERNELS:
        if suite_counts[name] or paper_counts[name] or gate_counts[name]:
            fail(f"{name} launched in phase 12")
    total = collections.Counter(suite_counts)
    total.update(paper_counts)
    print(f"phase 12 (perf gate): {time.perf_counter() - t0:.1f} s; launches over (a) and (b) {dict(total)}; "
          f"card {label}")
    return dict(total)


# ----------------------------------------------------------------- phase 9
SERVE_ARCH = "deepseek-v2-lite-16b"
SERVE_BATCHES = (4, 16)  # requests a generate
SERVE_NEW_TOKENS, SERVE_MAX_LEN = 16, 256  # the reference launcher's


def sync_timed(fn, sink: list):
    """``fn`` with its milliseconds, synchronised with the card on both
    sides, appended to ``sink``."""
    def wrapper(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def serve_batch(cfg, params, reqs: list, read_ms: float, card: str) -> dict:
    """Two ``generate`` runs of ``reqs`` (cold, then warm), each held to
    ``max_new_tokens`` tokens a request, L·N launches of K1 (one an MoE
    layer a forward; none without MoE) and one of K5; the same tokens
    both times; then one more under the profiler for the card's busy
    share.  Returns the launches of the two runs."""
    R, N = len(reqs), SERVE_NEW_TOKENS
    eng = ServeEngine(cfg, params, registry.get_model_api(cfg), max_len=SERVE_MAX_LEN)
    prefill_ms, decode_ms = [], []
    eng._prefill = sync_timed(eng._prefill, prefill_ms)
    eng._decode = sync_timed(eng._decode, decode_ms)
    total, outs = collections.Counter(), []
    want = {"sort_pairs_tile_tagged": 1}
    if cfg.is_moe:
        want["bucket_count_rank"] = cfg.num_layers * N
    for run in ("cold", "warm"):
        prefill_ms.clear()
        decode_ms.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(reqs)
        wall = time.perf_counter() - t0
        got = launch_counts()
        if sorted(out) != [r.id for r in reqs] or any(len(out[r.id]) != N for r in reqs):
            fail(f"generate of {R} requests did not give {N} tokens to each")
        if {k: v for k, v in got.items() if v} != want:
            fail(f"generate of {R} requests launched {got}, not {want}")
        total.update(got)
        outs.append(out)
        print(f"serve {cfg.name} R={R} N={N} {run} on {card}: prefill {prefill_ms[0]:.3f} ms, decode "
              f"{statistics.median(decode_ms):.3f} ms a step (median of {len(decode_ms)}; min {min(decode_ms):.3f}, "
              f"max {max(decode_ms):.3f}, first {decode_ms[0]:.3f}), wall {wall * 1e3:.1f} ms, "
              f"{R * N / wall:.1f} tokens/s; reading every parameter once at 3.35 TB/s takes {read_ms:.2f} ms; "
              f"launches {dict((k, v) for k, v in got.items() if v)}")
    if outs[0] != outs[1]:
        fail(f"two generate runs of the same {R} requests gave different tokens")
    busy_share(f"{cfg.name} generate R={R} N={N} on {card}", lambda: eng.generate(reqs))
    lens = [len(r.prompt) for r in reqs]
    order = [r.id for r in eng.order_by_length(reqs)]
    if order != [int(i) for i in np.argsort(lens, kind="stable")]:
        fail(f"order_by_length of {lens} gave {order}, not the stable argsort")
    print(f"  (d) order_by_length of {R} requests equals np.argsort(lens, kind='stable'); "
          f"first tokens of request 0: {outs[0][0][:8]}")
    return total


def plain_count_rank(ids, num_buckets):
    return partition_kernel.bucket_count_rank_plain(ids, num_buckets)


def moe_dispatch_checks(cfg, params, reqs: list) -> None:
    """(a) layer 0's ``apply_moe`` with K1 and with its plain version, and
    (b) the ``sorted`` and ``argsort`` dispatches, on the prefill and
    decode hidden states of ``reqs`` at the served config: bit for bit."""
    blk = layer(params["blocks"], 0)
    eng = ServeEngine(cfg, params, registry.get_model_api(cfg), max_len=SERVE_MAX_LEN)
    toks, _ = eng._pad_batch(reqs)
    argsort = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="argsort"))
    with torch.inference_mode():
        for what, t in (("prefill", toks), ("decode", toks[:, -1:])):
            h = layers.apply_norm(blk["ln2"], layers.embed_tokens(params["embedding"], t, cfg, NO_SHARD), cfg)
            y_k1, _ = moe.apply_moe(blk["moe"], h, cfg, NO_SHARD)
            kernel = moe.ops.bucket_count_rank
            moe.ops.bucket_count_rank = plain_count_rank
            try:
                y_plain, _ = moe.apply_moe(blk["moe"], h, cfg, NO_SHARD)
            finally:
                moe.ops.bucket_count_rank = kernel
            y_argsort, _ = moe.apply_moe(blk["moe"], h, argsort, NO_SHARD)
            if not torch.equal(y_k1, y_plain):
                fail(f"(a) apply_moe at {what} ({tuple(h.shape)}): K1 and its plain version differ")
            if not torch.equal(y_k1, y_argsort):
                fail(f"(b) apply_moe at {what} ({tuple(h.shape)}): the sorted and argsort dispatches differ")
            A = h.shape[0] * h.shape[1] * cfg.moe.num_experts_per_tok
            print(f"  (a), (b) apply_moe layer 0 at {what} {tuple(h.shape)}: {A} assignments over "
                  f"{cfg.moe.num_experts} experts, capacity {moe.capacity(A, cfg)}: K1, its plain version and "
                  f"the argsort dispatch give equal outputs bit for bit")


def serve_consistency(cfg, params, S: int = 24, extras=None) -> None:
    """(c) the reference's serve-consistency test at full width: float32
    compute (no TF32) and, with MoE, capacity factor 64, so no token drops
    at any T; prefill on S - 2 tokens and two decode steps against
    ``forward``.  ``extras(B, S)`` gives the family's other inputs
    (encoder frames; vision embeddings and their (3, B, S) positions)."""
    f32 = cfg.replace(dtype=torch.float32, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    api = registry.get_model_api(cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        B = 2
        gen = np.random.default_rng(1)
        toks = torch.from_numpy(gen.integers(0, cfg.vocab_size, (B, S))).to(DEV)
        batch = {"tokens": toks, **(extras(B, S) if extras else {})}
        head = dict(batch, tokens=toks[:, : S - 2])
        if "positions_thw" in batch:
            head["positions_thw"] = batch["positions_thw"][:, :, : S - 2]
        with torch.inference_mode():
            logits, _ = api.forward(params, batch, f32)
            cache = api.init_cache(f32, B, S + 4, device=DEV)
            last, cache = api.prefill(params, head, f32, NO_SHARD, cache)
            errs = [float((last - logits[:, S - 3]).abs().max())]
            for pos in (S - 2, S - 1):
                lg, cache = api.decode_step(params, toks[:, pos : pos + 1], f32, NO_SHARD, cache, pos)
                errs.append(float((lg - logits[:, pos]).abs().max()))
            del logits, cache
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not all(math.isfinite(e) for e in errs) or max(errs) >= 2e-2:
        fail(f"(c) {cfg.name}: prefill + decode against forward at full width: errors {errs}, limit 2e-2")
    print(f"  (c) {cfg.name}: float32 prefill of {S - 2} tokens + 2 decode steps against forward, B={B} S={S}"
          f"{' with ' + ', '.join(k for k in batch if k != 'tokens') if len(batch) > 1 else ''}: max abs error "
          f"{max(errs):.3e} (prefill {errs[0]:.3e}, decode {errs[1]:.3e}, {errs[2]:.3e}), limit 2e-2")


def moe_count_rank_times(cfg, batches: list) -> None:
    """K1 at the MoE dispatch's shapes (A = 6·T ids over 64 experts, T the
    prefill or decode tokens of a batch) against its plain version and
    ``torch.bincount`` plus a stable ``torch.sort``."""
    gen = np.random.default_rng(9)
    E = cfg.moe.num_experts
    for T in sorted({t for R, L in batches for t in (R * L, R)}):
        A = T * cfg.moe.num_experts_per_tok
        ids = torch.from_numpy(gen.integers(0, E, A).astype(np.int32)).to(DEV)
        kernel = cuda_ms(lambda: partition_kernel.bucket_count_rank(ids, E), reps=21)
        plain = cuda_ms(lambda: partition_kernel.bucket_count_rank_plain(ids, E), reps=5)
        library = cuda_ms(lambda: (torch.bincount(ids, minlength=E), torch.sort(ids, stable=True)), reps=21)
        b, by = bound(4 * A + 4 * E + 4 * A, 2 * A)
        print(f"kernel bucket_count_rank at the MoE dispatch, T={T} tokens, A={A} ids, B={E}: {kernel:.4f} ms "
              f"by events, plain {plain:.4f} ms, torch.bincount + stable torch.sort {library:.4f} ms, "
              f"bound {b:.2e} ms ({by})")


def build_model(arch: str, phase: int):
    """``arch`` at full width, its float32 weights made on the card from a
    seeded generator; fails unless its counted weights are
    ``cfg.param_count()``, plus the hybrid shared block's ``wq``, which
    the reference's count leaves out.  Returns (cfg, params, ms to read
    every weight once at the peak rate)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config(arch)
    t = time.perf_counter()
    params = registry.get_model_api(cfg).init(cfg, torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    built = time.perf_counter() - t
    leaves = tree_leaves(params)
    n, nbytes = lm.counted_params(params), sum(x.numel() * x.element_size() for x in leaves)
    shared_wq = cfg.d_model * cfg.num_heads * cfg.resolved_head_dim if cfg.is_hybrid else 0
    if n != cfg.param_count() + shared_wq:
        fail(f"{arch}: {n} counted parameters, the tree's layout gives {cfg.param_count() + shared_wq}")
    gap = (f" + {shared_wq:,} (the shared block's wq, which the reference's param_count() leaves out)"
           if shared_wq else "")
    print(f"phase {phase} model {arch} ({cfg.family}): {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}; {n:,} counted parameters = cfg.param_count() {cfg.param_count():,}{gap}; "
          f"{sum(x.numel() for x in leaves):,} with every leaf, {nbytes / 2**30:.2f} GiB of float32 weights made on "
          f"the card in {built:.2f} s; max allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return cfg, params, nbytes / PEAK_BYTES_S * 1e3


def model_serving() -> dict:
    """Phase 9: DeepSeek-V2-Lite-16B at full width on the card, served by
    ``ServeEngine`` over the port's model layer."""
    t0 = time.perf_counter()
    cfg, params, read_ms = build_model(SERVE_ARCH, 9)
    print(f"  {cfg.num_heads} heads, MLA rank {cfg.mla.kv_lora_rank}, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.num_experts_per_tok} + {cfg.moe.num_shared_experts} shared")
    total = collections.Counter()
    batches = []
    for R in SERVE_BATCHES:
        reqs = synthetic_requests(R, cfg.vocab_size, SERVE_NEW_TOKENS)
        total.update(serve_batch(cfg, params, reqs, read_ms, smi()))
        batches.append((R, max(len(r.prompt) for r in reqs)))
    print(f"  max allocated while serving {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    moe_dispatch_checks(cfg, params, synthetic_requests(SERVE_BATCHES[-1], cfg.vocab_size, SERVE_NEW_TOKENS))
    serve_consistency(cfg, params)
    moe_count_rank_times(cfg, batches)
    del params
    torch.cuda.empty_cache()
    print(f"phase 9 (model serving): {time.perf_counter() - t0:.1f} s; launches {dict(total)}")
    return dict(total)


# ---------------------------------------------------------------- phase 10
# Zamba2 first (served at 4 and 16 requests), then one arch of each other
# family (4 requests); (c) runs past two 256-position SSD chunks.
FAMILY_ARCHS = ("zamba2-2.7b", "mamba2-370m", "whisper-tiny", "qwen2-vl-7b")
SSM_CHECK_LEN = 602  # 2 x 256 + 90: the inter-chunk recurrence and a padded tail
VLM_CHECK_LEN, VLM_GRID = 1100, 32  # 1,024 vision tokens on a 32 x 32 patch grid, then text
LEAK_BYTES = 64 << 20  # what a freed model may leave allocated on the card


def allocated_back(base: int, label: str, phase: int = 10) -> None:
    """Fail unless the card's allocated memory is back within
    ``LEAK_BYTES`` of ``base``."""
    gc.collect()
    torch.cuda.empty_cache()
    now = torch.cuda.memory_allocated()
    print(f"  allocated after {label}: {now / 2**20:.1f} MiB (phase {phase} started at {base / 2**20:.1f} MiB)")
    if now - base > LEAK_BYTES:
        fail(f"{label}: {(now - base) / 2**20:.1f} MiB still allocated on the card")


def family_inputs(cfg):
    """``extras(B, S)`` for check (c): random encoder frames (encdec);
    random vision embeddings over the first ``vision_tokens`` positions
    with t = 0 and (h, w) on a ``VLM_GRID``-wide patch grid, then text
    positions equal on all three axes, which decode's broadcast position
    continues (vlm)."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    if cfg.family == "encdec":
        return lambda B, S: {"enc_frames": torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=gen, device=DEV)}
    if cfg.family == "vlm":
        def extras(B, S):
            V = cfg.vision_tokens
            thw = torch.arange(S, device=DEV).repeat(3, B, 1)
            idx = torch.arange(V, device=DEV)
            thw[0, :, :V], thw[1, :, :V], thw[2, :, :V] = 0, idx // VLM_GRID, idx % VLM_GRID
            ve = torch.randn((B, V, cfg.d_model), generator=gen, device=DEV) * cfg.d_model ** -0.5
            return {"vision_embeds": ve, "positions_thw": thw.to(torch.int32)}
        return extras
    return None


def ssd_check(cfg, params) -> None:
    """(e) layer 0's SSD at full width over 600 positions from a random
    state (random x, B and C, dt = softplus(normal + dt_bias), the layer's
    A), chunked against the decode update applied position by position,
    float32 with no TF32: within 1e-3 of the largest magnitude."""
    blk = layer(params["blocks"]["mamba"], 0)
    nh, hd, ng, ds = cfg.ssm_heads, cfg.ssm.head_dim, cfg.ssm.n_groups, cfg.ssm.d_state
    B, S = 2, 600
    gen = torch.Generator(device=DEV).manual_seed(3)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=DEV)  # noqa: E731
    x, B_, C, st0 = rand(B, S, nh, hd), rand(B, S, ng, ds), rand(B, S, ng, ds), rand(B, nh, hd, ds)
    dt = torch.nn.functional.softplus(rand(B, S, nh) + blk["dt_bias"].float())
    A = -torch.exp(blk["A_log"].float())
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            y, final = ssm.ssd_chunked(x, dt, A, B_, C, cfg, init_state=st0)
            st, ys = st0, []
            for t in range(S):
                yt, st = ssm.ssd_step(st, x[:, t], dt[:, t], A, B_[:, t].repeat_interleave(nh // ng, 1),
                                      C[:, t].repeat_interleave(nh // ng, 1))
                ys.append(yt)
            y_seq = torch.stack(ys, 1)
            chunked_ms = cuda_ms(lambda: ssm.ssd_chunked(x, dt, A, B_, C, cfg, init_state=st0), reps=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rel_y = float((y - y_seq).abs().max() / y_seq.abs().max())
    rel_s = float((final - st).abs().max() / st.abs().max())
    if not (rel_y <= 1e-3 and rel_s <= 1e-3):
        fail(f"(e) {cfg.name}: ssd_chunked against the sequential update: relative errors {rel_y}, {rel_s}, limit 1e-3")
    print(f"  (e) {cfg.name}: ssd_chunked (B={B}, S={S}, {nh} heads of {hd}, d_state {ds}, chunks of "
          f"{cfg.ssm.chunk_size}) against {S} decode updates: relative error outputs {rel_y:.3e}, final state "
          f"{rel_s:.3e}, limit 1e-3; ssd_chunked {chunked_ms:.3f} ms by events")


def serve_family(arch: str, card: str) -> dict:
    """One arch at full width: built on the card, served, checked; its
    launches.  The caller frees it."""
    t0 = time.perf_counter()
    cfg, params, read_ms = build_model(arch, 10)
    total = collections.Counter()
    for R in SERVE_BATCHES if arch == FAMILY_ARCHS[0] else SERVE_BATCHES[:1]:
        reqs = synthetic_requests(R, cfg.vocab_size, SERVE_NEW_TOKENS)
        total.update(serve_batch(cfg, params, reqs, read_ms, card))
    print(f"  {arch}: max allocated while serving {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    S = {"encdec": 24, "vlm": VLM_CHECK_LEN}.get(cfg.family, SSM_CHECK_LEN)
    serve_consistency(cfg, params, S, family_inputs(cfg))
    if cfg.ssm.d_state:
        ssd_check(cfg, params)
    print(f"  {arch}: {time.perf_counter() - t0:.1f} s; max allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB on {card}")
    del params
    return total


def model_families() -> dict:
    """Phase 10: the ssm, hybrid, encdec and vlm families at full width on
    the card, one model at a time."""
    t0 = time.perf_counter()
    card = smi()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    if base > 1 << 30:
        fail(f"{base / 2**30:.2f} GiB still allocated after phase 9 freed DeepSeek-V2-Lite")
    print(f"phase 10 starts with {base / 2**20:.1f} MiB allocated on the card (DeepSeek-V2-Lite's 60 GiB freed)")
    total = collections.Counter()
    for arch in FAMILY_ARCHS:
        total.update(serve_family(arch, card))
        allocated_back(base, arch)
    print(f"phase 10 (model families): {time.perf_counter() - t0:.1f} s; launches {dict(total)}; card {card}")
    return dict(total)


# ---------------------------------------------------------------- phase 11
TRAIN_ARCH = "deepseek-v2-lite-16b"
# Full width, depth cut from 27 to 4: float32 parameters, gradients and
# AdamW's m and v of all 27 layers take 241.6 GiB.  train_4k's 4,096
# tokens a sequence, its batch cut from 256 to 2.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 4096, 2, 6
TRAIN_MEMORY_LIMIT = 75 << 30  # max allocated past this: cut the batch to 1
BF16_OPS_S = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
RESUME_ARCH = "mamba2-370m"


def train_ops(cfg, tokens: int) -> tuple[float, float]:
    """Matmul operations of one remat train step (forward, backward, and
    the layers' forward again), as (bf16, float32): 2·N·D a forward pass
    over the weights each token uses (the routed experts at the dispatch
    buffer's E·C rows) and 4·N·D for its backward, in bf16; QKᵀ and P·V
    over every (query, key) pair the chunked attention computes (all S² of
    them), on float32 operands."""
    m, a = cfg.moe, cfg.mla
    d, H, L = cfg.d_model, cfg.num_heads, cfg.num_layers
    attn_w = d * H * (a.qk_nope_head_dim + a.qk_rope_head_dim) + d * (a.kv_lora_rank + a.qk_rope_head_dim) \
        + a.kv_lora_rank * H * (a.qk_nope_head_dim + a.v_head_dim) + H * a.v_head_dim * d
    shared = 3 * d * m.shared_d_ff * m.num_shared_experts + d * m.num_experts
    routed_rows = m.num_experts * moe.capacity(tokens * m.num_experts_per_tok, cfg)
    layer = 2 * (attn_w + shared) * tokens + 2 * 3 * d * m.expert_d_ff * routed_rows
    scores = 2 * TRAIN_BATCH * TRAIN_SEQ * TRAIN_SEQ * H * (a.qk_nope_head_dim + a.qk_rope_head_dim + a.v_head_dim)
    unembed = 2 * d * cfg.vocab_size * tokens
    return 3 * (L * layer + unembed) + L * layer, 4 * L * scores


def train_main(card: str) -> dict:
    """(a) DeepSeek-V2-Lite at full width, 4 layers, trained 6 steps
    through ``Trainer(device="cuda")``: finite, falling losses, 8 launches
    of K1 a step (4 MoE layers, forward and remat recompute); then one
    more step under the profiler for the card's busy share."""
    cfg = registry.get_config(TRAIN_ARCH).replace(num_layers=TRAIN_LAYERS)
    full = registry.get_config(TRAIN_ARCH)
    state_gib = 4 * 4 * full.param_count() / 2**30
    print(f"phase 11 (a) reduced: depth {full.num_layers} -> {TRAIN_LAYERS} layers (float32 parameters, gradients, "
          f"m and v of the full depth: {state_gib:.1f} GiB of counted weights alone); batch 256 -> {TRAIN_BATCH} "
          f"(train_4k's {TRAIN_SEQ} tokens a sequence); widths as published")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        run = RunConfig(model=cfg, shape=ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"), warmup_steps=1,
                        total_steps=TRAIN_STEPS, checkpoint_every=0, checkpoint_dir=ckpt)
        tr = Trainer(cfg, run, registry.get_model_api(cfg), device=DEV)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        leaves = tree_leaves(tr.state["params"])
        n = lm.counted_params(tr.state["params"])
        if n != cfg.param_count():
            fail(f"the 4-layer DeepSeek-V2-Lite counts {n} weights, cfg.param_count() {cfg.param_count()}")
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        print(f"  built {n:,} counted weights (cfg.param_count()), {sum(x.numel() for x in leaves):,} in all: "
              f"{nbytes / 2**30:.2f} GiB of float32 weights and {2 * nbytes / 2**30:.2f} GiB of AdamW moments on "
              f"the card in {built:.2f} s; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        reset_launches()
        per_step = []
        for _ in range(TRAIN_STEPS):
            before = launch_counts()["bucket_count_rank"]
            tr.run_steps(1)
            per_step.append(launch_counts()["bucket_count_rank"] - before)
        log = tr.metrics_log
        losses = [m["loss"] for m in log]
        walls = [m["wall_s"] * 1e3 for m in log]
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            fail(f"(a) a training loss is not finite: {losses}")
        if not losses[-1] < losses[0]:
            fail(f"(a) the loss did not fall over {TRAIN_STEPS} steps: {losses}")
        if per_step != [2 * TRAIN_LAYERS] * TRAIN_STEPS:
            fail(f"(a) K1 launched {per_step} times a step, not {2 * TRAIN_LAYERS}")
        if peak > TRAIN_MEMORY_LIMIT:
            fail(f"(a) max allocated {peak / 2**30:.2f} GiB passes {TRAIN_MEMORY_LIMIT / 2**30:.0f} GiB: cut the batch")
        tokens = TRAIN_BATCH * TRAIN_SEQ
        warm = statistics.median(walls[1:])
        ops16, ops32 = train_ops(cfg, tokens)
        floor_ms = (ops16 / BF16_OPS_S + ops32 / PEAK_OPS_S) * 1e3
        print(f"  (a) {TRAIN_STEPS} steps on {card}: losses {[round(x, 4) for x in losses]}; lr "
              f"{[m['lr'] for m in log]}; grad_norm {[round(m['grad_norm'], 3) for m in log]}; aux "
              f"{[round(m['aux'], 5) for m in log]}")
        print(f"  (a) step ms (host clock, synchronised by .item()): {[round(w, 1) for w in walls]}; warm median "
              f"{warm:.1f} ms, {tokens / warm * 1e3:.0f} tokens/s; max allocated {peak / 2**30:.2f} GiB; K1 launches "
              f"a step {per_step}; matmul operations a step {ops16 / 1e12:.2f} T bf16 + {ops32 / 1e12:.2f} T float32 "
              f"(attention), {floor_ms:.1f} ms at the peaks (989 T/s bf16, 67 T/s float32)")
        busy_share(f"one DeepSeek-V2-Lite train step (4 layers, {TRAIN_BATCH} x {TRAIN_SEQ}) on {card}",
                   lambda: tr.run_steps(1))
        total = launch_counts()
        if total["bucket_count_rank"] != 2 * TRAIN_LAYERS * (TRAIN_STEPS + 1):
            fail(f"(a) K1 launched {total['bucket_count_rank']} times in {TRAIN_STEPS + 1} steps")
        del tr, leaves
    return {k: v for k, v in total.items() if v}


def train_dispatch_twins() -> None:
    """(b), run in a process of its own with ``CUBLAS_WORKSPACE_CONFIG``
    set and deterministic algorithms on: one step's loss and gradients of
    DeepSeek-V2-Lite at full width, 1 layer, with the ``sorted`` dispatch
    (K1) and with ``argsort`` (``torch.sort``), bit for bit."""
    torch.use_deterministic_algorithms(True)
    cfg = registry.get_config(TRAIN_ARCH).replace(num_layers=1)
    run = RunConfig(model=cfg)
    params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
    batch = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=DEV).next_batch()
    out = {}
    for dispatch in ("sorted", "argsort"):
        c = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
        reset_launches()
        loss, _, aux, grads = make_grad_fn(c, run, lm)(params, batch)
        torch.cuda.synchronize()
        out[dispatch] = loss, aux, grads, launch_counts()["bucket_count_rank"]
    (l1, a1, g1, n1), (l2, a2, g2, n2) = out["sorted"], out["argsort"]
    if (n1, n2) != (2, 0):
        fail(f"(b) K1 launched {n1} times with sorted (want 2: forward and recompute) and {n2} with argsort")
    if not (torch.equal(bits(l1), bits(l2)) and torch.equal(bits(a1), bits(a2))):
        fail(f"(b) the sorted and argsort losses differ: {float(l1)!r} {float(l2)!r}")
    diff = [k for k, (x, y) in enumerate(zip(g1, g2)) if not torch.equal(bits(x), bits(y))]
    if diff:
        fail(f"(b) {len(diff)} of {len(g1)} gradient leaves differ between the sorted and argsort dispatches")
    print(f"  (b) DeepSeek-V2-Lite 1 layer, {TRAIN_BATCH} x {TRAIN_SEQ}: loss {float(l1)!r} and aux {float(a1)!r} "
          f"with sorted (K1, {n1} launches) and argsort, bit for bit; all {len(g1)} gradient leaves bit for bit "
          f"under torch.use_deterministic_algorithms(True)")


def train_dispatch_times(card: str, row: dict) -> None:
    """K1 at the training dispatch's shape (6 · 2 · 4096 = 49,152 ids over
    64 experts) by events and on the device, beside its plain version and
    ``torch.bincount`` + a stable ``torch.sort``; added to K1's row."""
    cfg = registry.get_config(TRAIN_ARCH)
    E, A = cfg.moe.num_experts, cfg.moe.num_experts_per_tok * TRAIN_BATCH * TRAIN_SEQ
    gen = np.random.default_rng(11)
    ids = torch.from_numpy(gen.integers(0, E, A).astype(np.int32)).to(DEV)
    kc, kr = partition_kernel.bucket_count_rank(ids, E)
    pc, pr = partition_kernel.bucket_count_rank_plain(ids, E)
    err = max(same(kc, pc, "bucket_count_rank counts at the training shape"),
              same(kr, pr, "bucket_count_rank ranks at the training shape"))
    ms = cuda_ms(lambda: partition_kernel.bucket_count_rank(ids, E), reps=21)
    dev_ms, launches = bcr_profile(lambda: partition_kernel.bucket_count_rank(ids, E))
    plain = cuda_ms(lambda: partition_kernel.bucket_count_rank_plain(ids, E), reps=5)
    library = cuda_ms(lambda: (torch.bincount(ids, minlength=E), torch.sort(ids, stable=True)), reps=21)
    b, by = bound(4 * A + 4 * E + 4 * A, 2 * A)
    row.update(train_shape=f"{A} ids, B={E}", train_ms=ms, train_device_ms=dev_ms, train_plain_ms=plain,
               train_library_ms=library, train_bound_ms=b, train_max_abs_err=err)
    print(f"kernel bucket_count_rank at the training dispatch, A={A} ids, B={E}, on {card}: {ms:.4f} ms by events, "
          f"device {dev_ms} ms ({launches} kernel launches), plain {plain:.4f} ms, torch.bincount + stable "
          f"torch.sort {library:.4f} ms, bound {b:.2e} ms ({by}); equal to the plain version")


def train_launcher() -> None:
    """(c) ``python -m repro_torch.launch.train --arch mamba2-370m --steps 3``
    at full width and depth on the card, in a process of its own."""
    with tempfile.TemporaryDirectory() as ckpt:
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", RESUME_ARCH, "--steps", "3",
               "--ckpt-dir", ckpt]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"(c) {' '.join(cmd[1:7])} exited {r.returncode}: {r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    m = re.match(r"loss: (\S+) -> (\S+);", lines[-1]) if lines else None
    if not m or not all(math.isfinite(float(x)) for x in m.groups()):
        fail(f"(c) the launcher printed no finite loss: {r.stdout[-2000:]}")
    print(f"  (c) python -m repro_torch.launch.train --arch {RESUME_ARCH} --steps 3, "
          f"{time.perf_counter() - t0:.1f} s with the process's start: {' | '.join(lines[-2:])}")


def train_resume(card: str) -> None:
    """(d) mamba2-370m at full width trained 3 steps with a checkpoint
    every 2 (synchronous saves); a second ``Trainer`` on the directory
    resumes at step 2 with the data at step 2, and its step-2 loss equals
    the first trainer's bit for bit."""
    cfg = registry.get_config(RESUME_ARCH)
    api = registry.get_model_api(cfg)
    with tempfile.TemporaryDirectory() as ckpt:
        run = RunConfig(model=cfg, shape=ShapeConfig("cli", 128, 8, "train"), warmup_steps=1, total_steps=3,
                        checkpoint_every=2, checkpoint_dir=ckpt)
        tr = Trainer(cfg, run, api, device=DEV, sync_checkpoints=True)
        want = [m["loss"] for m in tr.run_steps(3)]
        saved = tr.ckpt.steps()
        del tr
        t0 = time.perf_counter()
        tr = Trainer(cfg, run, api, device=DEV)
        resumed = time.perf_counter() - t0
        step, data_step = int(tr.state["step"]), tr.data.step
        got = tr.run_steps(1)[0]["loss"]
        del tr
    if saved != [2] or (step, data_step) != (2, 2):
        fail(f"(d) checkpoints {saved}; resumed at step {step} with the data at {data_step}, not 2 and 2")
    if got != want[2]:
        fail(f"(d) the resumed step-2 loss {got!r} differs from the first trainer's {want[2]!r}")
    print(f"  (d) {RESUME_ARCH} 8 x 128 on {card}: losses {want}; resumed from step_2 in {resumed:.2f} s (init and "
          f"restore) at step 2, data step 2; its step-2 loss {got!r} equals the first run's bit for bit")


def model_training(rows: dict) -> dict:
    """Phase 11: training on the card: (a) DeepSeek-V2-Lite at full width
    through K1's dispatch, (b) the dispatch's K1 and argsort twins bit for
    bit (a process of its own) and K1 timed at the training shape, (c) the
    training launcher, (d) resume from a checkpoint."""
    t0 = time.perf_counter()
    card = smi()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    if base > 1 << 30:
        fail(f"{base / 2**30:.2f} GiB still allocated after phase 10 freed its models")
    print(f"phase 11 starts with {base / 2**20:.1f} MiB allocated on the card")
    counts = train_main(card)
    allocated_back(base, "(a) DeepSeek-V2-Lite training", 11)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.train_dispatch_twins()"], env=env,
                       cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    print(r.stdout.strip())
    if r.returncode != 0:
        fail(f"(b) the sorted/argsort training twins failed (exit {r.returncode}): {r.stderr[-3000:]}")
    train_dispatch_times(card, rows["bucket_count_rank"])
    train_launcher()
    train_resume(card)
    allocated_back(base, "(d) mamba2-370m resume", 11)
    print(f"phase 11 (model training): {time.perf_counter() - t0:.1f} s; launches {counts}; card {card}")
    return counts


def main() -> None:
    preflight()
    rows = kernel_checks()

    reset_launches()
    main_path_sort()
    sort_counts = launch_counts()
    print("launches on SortEngine.sort:", sort_counts)
    for name in ("bucket_count_rank", "sort_tile", "merge_tiles"):
        if sort_counts[name] == 0:
            fail(f"{name} never launched on the SortEngine.sort path")

    reset_launches()
    main_path_segments()
    seg_counts = launch_counts()
    print("launches on SortEngine.sort_segments:", seg_counts)
    if seg_counts["batched_row_sort"] == 0:
        fail("batched_row_sort never launched on the sort_segments path")
    if seg_counts["sort_tile"] or seg_counts["merge_tiles"]:
        fail("sort_segments rows went through the tile kernels, not the row kernel")

    long_segments()

    reset_launches()
    pairs_path()
    pair_counts = launch_counts()
    print("launches on the pairs path (sort_pairs, argsort_keys):", pair_counts)
    if pair_counts["sort_pairs_tile_tagged"] == 0:
        fail("sort_pairs_tile_tagged never launched on the pairs path")

    reset_launches()
    workloads_path()
    work_counts = launch_counts()
    print("launches on top_k and merge_sorted:", work_counts)

    t0 = time.perf_counter()
    serve_counts = {name: 0 for name in KERNELS}
    serve_counts.update(serving_path())
    print(f"launches on the serving path (Sortd, fault ladder, fleet), {time.perf_counter() - t0:.1f} s:", serve_counts)

    verify_counts = conformance()
    perf_counts = {name: 0 for name in KERNELS}
    perf_counts.update(perf_gate())

    model_counts = {name: 0 for name in KERNELS}
    model_counts.update(model_serving())
    family_counts = {name: 0 for name in KERNELS}
    family_counts.update(model_families())
    if family_counts["sort_pairs_tile_tagged"] == 0:
        fail("sort_pairs_tile_tagged never launched on the model families' path")
    train_counts = {name: 0 for name in KERNELS}
    train_counts.update(model_training(rows))
    if train_counts["bucket_count_rank"] == 0:
        fail("bucket_count_rank never launched on the training path")

    launches = {
        **sort_counts,
        "batched_row_sort": seg_counts["batched_row_sort"],
        "sort_pairs_tile_tagged": pair_counts["sort_pairs_tile_tagged"],
    }
    for name in launches:
        launches[name] += (serve_counts[name] + verify_counts[name] + perf_counts[name] + model_counts[name]
                           + family_counts[name] + train_counts[name])
    # K6 and K7 have no caller in either package: phase 2 checks them, and
    # every path run above must have launched them no time
    for name in ("batched_row_sort_pairs", "sort_pairs_tile"):
        launches[name] = sum(
            c[name]
            for c in (sort_counts, seg_counts, pair_counts, work_counts, serve_counts, verify_counts, perf_counts,
                      model_counts, family_counts, train_counts)
        )
        if launches[name]:
            fail(f"{name} launched {launches[name]} times on a path: it has a caller now, so "
                 "the kernels line must count that path's launches")
    if set(rows) != set(KERNELS):
        fail(f"kernels not checked in phase 2: {sorted(set(KERNELS) - set(rows))}")
    unseen = [name for name, r in rows.items() if r.get("device_ms") is None or r.get("launches_per_call") is None]
    if unseen:
        fail(f"no device time or launch count from the profiler for {unseen}")
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r.get("device_ms"),
            "launches_per_call": r.get("launches_per_call"),
            "checked": "phase 2, bit for bit against the plain version",
            **{k: v for k, v in r.items() if k.startswith("train_")},
        })
    print("card:", smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
