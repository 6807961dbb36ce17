"""Unified autotuned sort engine, torch port (counterpart of
``repro.core.engine``).

The same policy over the port's paths: a strided sample gives
``InputStats``; ``choose_plan`` picks the path (sim / host) and method;
``autotune_capacity`` sizes the per-bucket buffer from the measured max
bucket fraction; ``sort`` escalates capacity ×2 on overflow, so the answer
is always exact.  The planners are numpy copies of the reference's and
give the same plans field for field, with one deliberate change: 64-bit
integer keys plan onto the sim path (the reference sends them to the host
only because jax without x64 downcasts them).

The sim path runs on the card: exact equal-width bucket ids
(``_paper_ids``) → the ``bucket_count_rank`` kernel and a scatter into a
``(P, capacity)`` buffer → one ``local_sort`` over every bucket row (the
bitonic ``sort_tile``/``merge_tiles`` kernels) → the merge-free gather.
``sort_segments`` sorts a packed ``(B, Lbucket)`` batch with the fused
``batched_row_sort`` kernel.  The plan method names are the reference's:
the row backends named ``pallas``/``pallas2op`` (methods
``bitonic_pallas``/``bitonic2op``) now launch the hand-written CUDA row
kernel, and ``vmap`` (method ``bitonic``) is ``torch.sort`` over the rows,
PyTorch's library sort, which runs only when ``REPRO_ROW_BACKEND`` forces
it.

There is no jit: an *executor* is a Python closure over the static plan
(pow2 size bucket, capacity, method, dtype), cached like the reference's
compiled executables, and ``trace_count`` counts executor builds.

The workload operations run on the same kernels.  ``sort_pairs`` takes a
flat payload through the tagged pair kernel (``ops.local_sort_pairs``,
one launch a request) and returns tensors on the engine's device; any
other payload pytree rides ``argsort_keys`` (the same kernel over
``(key, arange)``) and a host gather of every leaf, returning numpy as
the reference does.  ``top_k`` is the bucket machinery with the buckets
past the cut skipped (``_sim_topk_padded``: K1, one ``local_sort`` over
the kept rows, the gather), or the exact host head; ``merge_sorted``
sorts the increment through ``sort`` and merges on the host.  64-bit
integer keys run on the kernels there too; keys of a dtype no kernel
takes (float64, float16) and argsorts past ``ops.MAX_TILE`` take the
host stable argsort, a planned route named in ``last_report``.

Fault scenarios (``fault_scenario=``, ``set_fault_scenario``) run the
reference's fallback ladder over ``repro_torch.net``: a healthy topology
leaves the plan alone; a degraded one whose gather is still possible
keeps the path and prices the gather over the rebuilt schedule
(``fault``, ``fault_slowdown``); one whose gather is impossible sends
``sort`` onto the host path and ``sort_segments`` onto an exact
per-segment host sort, so no kernel runs.  The classification and the
prices are pure Python, cached per scenario name and size bucket.

The dist path (``SortEngine(mesh=...)``, a ``DeviceMesh`` of ranks that
each run the engine, SPMD) plans with the reference's mesh rules (``hier``
on two or more axes, else ``valiant`` / ``sample`` / ``paper``) and sorts
through ``repro_torch.core.dist_sort``: K1 buckets every rank's shard, one
``all_to_all`` per hop exchanges the rows, K2/K3 sort what each rank
received.  Every rank passes the same array and gets the whole sorted
array back, all-gathered from the shards.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import threading
import time
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import dtypes, tracing
from repro_torch.core import partition, pytree, workloads
from repro_torch.core.dist_sort import dist_sort_keys
from repro_torch.core.ohhc_sort import ohhc_sort_host
from repro_torch.core.topology import OHHCTopology
from repro_torch.core.workloads import TopKTooLarge
from repro_torch.kernels import batched as batched_kernels
from repro_torch.kernels import bitonic, ops
from repro_torch.runtime import ranks

# Most bytes of pinned answers that ``sort`` keeps checked out to callers
# at once (``_PinnedAnswers``).  An answer past it comes back in pageable
# memory, as it did before pinned answers, so a caller that holds many is
# never slower than that and pins no more than this.
PINNED_ANSWER_CEILING = 8 << 30

# Granularity cap for stats histograms: coarser than P only ever
# *over*-estimates the max bucket fraction (refining buckets can't raise it).
_MAX_STAT_BUCKETS = 256

# Largest row bucket the segmented batch path sorts with the direct
# sentinel-padded row kernel instead of the P-way bucket machinery.
SEGMENT_BITONIC_MAX = 1 << 13

# Row-sort backends of the bitonic segment path.  ``vmap`` is torch.sort
# over the rows (the counterpart of the reference's vmapped XLA sort);
# ``pallas`` and ``pallas2op`` are the hand-written batched row kernel with
# the 4-op and the NICE 2-op compare-exchange stage.  Each backend is a
# distinct plan method, so the executor cache and ``SortPlan.reason`` name
# the kernel that ran.
ROW_BACKENDS = ("vmap", "pallas", "pallas2op")
_BACKEND_METHODS = {
    "vmap": "bitonic",
    "pallas": "bitonic_pallas",
    "pallas2op": "bitonic2op",
}
# Every method string that means "direct sentinel-padded row sort" — no
# capacity, no overflow (the complement of the bucket-path methods).
BITONIC_METHODS = tuple(_BACKEND_METHODS.values())

_KERNEL_NP_DTYPES = frozenset(
    np.dtype(str(t).removeprefix("torch.")) for t in bitonic.DTYPE_CODES
)

# One measured head-to-head per (device type, row bucket, dtype, probe
# batch) per process — shared across engines so a fleet of workers probes
# once.
_ROW_BACKEND_CACHE: dict[tuple[str, int, str, int], tuple[str, str]] = {}

# The probe batch is bucketed to the serving batch (pow2, clamped):
# relative backend cost depends on the batch.
_PROBE_BATCH_MIN, _PROBE_BATCH_MAX = 8, 64


def kernel_keys(dtype) -> bool:
    """True when keys of ``dtype`` reach the port's kernels (after the
    unsigned → signed map of ``repro_torch.dtypes``)."""
    return dtypes.key_dtype(dtype) in _KERNEL_NP_DTYPES


def _probe_batch_for(batch_hint: int) -> int:
    b = max(int(batch_hint), 1)
    return min(max(1 << (b - 1).bit_length(), _PROBE_BATCH_MIN), _PROBE_BATCH_MAX)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def choose_row_backend(
    padded_n: int,
    dtype,
    *,
    device="cuda",
    batch_hint: int = 8,
    probe_batch: "int | None" = None,
    repeats: int = 3,
) -> tuple[str, str]:
    """Row-sort backend for bitonic segment rows.

    ``REPRO_ROW_BACKEND`` forces one (``vmap`` / ``pallas`` /
    ``pallas2op``) and skips the probe.  Unset, it races the hand-written
    kernel's two stages on ``device`` at the serving batch size: ``pallas``
    against ``pallas2op`` for integer keys (floats have only the 4-op
    stage).  The library sort ``vmap`` is never a candidate.

    Returns ``(backend, detail)``; ``detail`` lands in ``SortPlan.reason``.
    """
    forced = os.environ.get("REPRO_ROW_BACKEND", "").strip().lower()
    if forced:
        if forced not in ROW_BACKENDS:
            raise ValueError(
                f"REPRO_ROW_BACKEND={forced!r} not in {ROW_BACKENDS}"
            )
        return forced, f"row_backend={forced} (forced via REPRO_ROW_BACKEND)"
    device = torch.device(device)
    key_np = dtypes.key_dtype(dtype)
    if not np.issubdtype(key_np, np.integer):
        return "pallas", "row_backend=pallas (float keys: 4-op stage only)"
    if probe_batch is None:
        probe_batch = _probe_batch_for(batch_hint)
    key = (device.type, padded_n, str(key_np), probe_batch)
    hit = _ROW_BACKEND_CACHE.get(key)
    if hit is not None:
        return hit
    rng = np.random.default_rng(padded_n)
    info = np.iinfo(key_np)
    x = torch.from_numpy(
        rng.integers(info.min, info.max, (probe_batch, padded_n), dtype=key_np)
    ).to(device)
    lens = torch.full((probe_batch,), padded_n, dtype=torch.int32, device=device)
    timings: dict[str, float] = {}
    for name, method in (("pallas", "bitonic"), ("pallas2op", "bitonic2op")):
        batched_kernels.batched_row_sort(x, lens, method=method)  # warm: build outside the clock
        _sync(device)
        best = math.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            batched_kernels.batched_row_sort(x, lens, method=method)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        timings[name] = best
    backend = min(timings, key=timings.get)  # type: ignore[arg-type]
    detail = "row_backend=%s (autotuned @B%d: %s)" % (
        backend,
        probe_batch,
        ", ".join(f"{k} {v * 1e3:.2f}ms" for k, v in timings.items()),
    )
    _ROW_BACKEND_CACHE[key] = (backend, detail)
    return backend, detail


# --------------------------------------------------------------------------
# Input statistics
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputStats:
    """Cheap sampled statistics of one sort request."""

    n: int
    dtype: str
    sample_size: int
    sortedness: float  # +1 ascending … −1 descending, ties neutral
    skew: float  # max/mean of the equal-width histogram (1.0 = balanced)
    dup_top_frac: float  # mass of the most frequent sampled value
    f_max_paper: float  # measured max bucket fraction, equal-width rule
    f_max_sampled: float  # measured max bucket fraction, sampled splitters
    num_buckets: int  # histogram granularity the f_max fields used

    @property
    def label(self) -> str:
        """Best-guess class in the paper's §5 taxonomy (+ 'dupes')."""
        if self.sortedness > 0.8:
            return "sorted"
        if self.sortedness < -0.8:
            return "reversed"
        if self.dup_top_frac > 0.25:
            return "dupes"
        if self.skew > 4.0:
            return "local"
        return "random"

    @property
    def skewed(self) -> bool:
        """True when equal-width ranges would overload some processor."""
        return self.skew > 2.0 or self.dup_top_frac > 0.25


def estimate_stats(
    x, *, num_buckets: int = 64, sample_size: int = 2048
) -> InputStats:
    """Measure ``InputStats`` from an evenly spread sample (host, O(sample)).

    Exactly ``min(n, sample_size)`` linspace-positioned elements: the sample
    spans the whole array (order statistics like sortedness stay meaningful
    on sorted inputs) and its size never halves across nearby ``n`` — a
    stable ``s`` keeps the 3σ term in :func:`autotune_capacity`, and hence
    the chosen capacity and executor-cache key, stable across a shape bucket.
    """
    x = np.asarray(x).ravel()
    n = x.size
    if n == 0:
        return InputStats(0, str(x.dtype), 0, 1.0, 1.0, 0.0, 0.0, 0.0, num_buckets)
    s = int(min(n, sample_size))
    idx = (np.arange(s, dtype=np.int64) * n) // s
    sample = x[idx].astype(np.float64)
    diffs = np.diff(sample)
    sortedness = (
        float(np.mean(diffs > 0) - np.mean(diffs < 0)) if diffs.size else 1.0
    )
    _, uniq_counts = np.unique(sample, return_counts=True)
    dup_top_frac = float(uniq_counts.max()) / s

    B = int(min(num_buckets, _MAX_STAT_BUCKETS))
    lo, hi = sample.min(), sample.max()
    width = (hi - lo) / B
    if width <= 0:
        ids = np.zeros(s, np.int64)
    else:
        ids = np.clip(((sample - lo) / width).astype(np.int64), 0, B - 1)
    counts = np.bincount(ids, minlength=B)
    f_max_paper = float(counts.max()) / s
    skew = f_max_paper * B  # max / (s/B)

    srt = np.sort(sample)
    splitters = srt[(np.arange(1, B) * s) // B]
    ids2 = np.searchsorted(splitters, sample, side="right")
    f_max_sampled = float(np.bincount(ids2, minlength=B).max()) / s

    return InputStats(
        n=n,
        dtype=str(x.dtype),
        sample_size=s,
        sortedness=sortedness,
        skew=float(skew),
        dup_top_frac=dup_top_frac,
        f_max_paper=f_max_paper,
        f_max_sampled=f_max_sampled,
        num_buckets=B,
    )


def estimate_batch_stats(
    padded: np.ndarray,
    seg_lens,
    *,
    num_buckets: int = 64,
    sample_size: int = 256,
) -> InputStats:
    """Worst-row ``InputStats`` for a packed ``(B, row_len)`` segment batch.

    One fused device call (``SortEngine.sort_segments``) must pick a single
    capacity for every row, so the quantity that matters is the *worst row's*
    max bucket fraction — a blended whole-batch histogram would wash a
    single pathological row out of the estimate and buy an overflow retry
    per flush.  Everything here is vectorized numpy over a strided
    ``(B, s)`` per-row sample (no per-row Python loop — the point of the
    segmented path):

    * per-row equal-width bucket counts via one offset ``bincount`` →
      ``f_max_paper``.  The sample is bucketed against each row's **true**
      min/max (one vectorized masked pass over the packed matrix — we paid
      for the pack already), not the sample's own range: a clustered row
      with tail outliers (the paper's "local" class) has a true range the
      sample misses, and the kernel's equal-width rule uses the true range —
      sample-range bucketing underestimates its hot bucket by >10×;
    * per-row top-duplicate mass via run lengths of the sorted sample
      (``dup_top_frac``); under sampled (quantile) splitters only
      indivisible duplicate mass can overload a bucket, so
      ``f_max_sampled = max(1/num_buckets, dup_top_frac)``;
    * ``sortedness`` is the mean over rows (label/diagnostics only — batch
      method choice keys off skew and duplicates).

    Per-row fractions are scaled by ``len/row_len`` before the worst-row
    reduction: capacity is measured in *elements* of a padded row, and a
    short row's hot bucket holds at most its own length — without the
    scaling one 1-element row (f̂ = 1.0 by definition) would size every
    batch buffer at the full row length.  Rows of length 0 are masked out
    of every reduction.
    """
    padded = np.asarray(padded)
    lens = np.asarray(seg_lens, dtype=np.int64).ravel()
    B, row_len = padded.shape
    total = int(lens.sum())
    dtype = str(padded.dtype)
    nb = int(min(num_buckets, _MAX_STAT_BUCKETS))
    live = lens > 0
    if total == 0 or not live.any():
        return InputStats(total, dtype, 0, 1.0, 1.0, 0.0, 0.0, 0.0, nb)
    s = int(min(row_len, sample_size))
    # Strided per-row sample over each row's own valid prefix: index
    # (j·len)//s < len for every len ≥ 1, so no pad cell is ever sampled
    # from a live row.
    idx = (np.arange(s)[None, :] * lens[:, None]) // s
    samp = padded[np.arange(B)[:, None], np.clip(idx, 0, row_len - 1)]
    samp = samp.astype(np.float64)

    # True per-row range over the valid prefix (pad cells masked out): the
    # kernel's equal-width buckets use it, so the estimate must too.
    pos = np.arange(row_len)[None, :]
    valid = pos < lens[:, None]
    pf = padded.astype(np.float64)
    lo = np.where(valid, pf, np.inf).min(axis=1)
    hi = np.where(valid, pf, -np.inf).max(axis=1)
    lo = np.where(live, lo, 0.0)
    width = np.where(live, (hi - lo) / nb, 1.0)
    width = np.where(width > 0, width, 1.0)
    # clip in float BEFORE the integer cast: dead rows sample their fill
    # value (dtype max / inf), which overflows a float→int64 cast
    ids = np.clip((samp - lo[:, None]) / width[:, None], 0, nb - 1).astype(np.int64)
    counts = np.bincount(
        (ids + np.arange(B)[:, None] * nb).ravel(), minlength=B * nb
    ).reshape(B, nb)
    # elements-of-a-padded-row units: f̂_row · (len/row_len)
    row_scale = lens / float(row_len)
    f_rows = counts.max(axis=1) / s * row_scale
    f_max_paper = float(f_rows[live].max())

    srt = np.sort(samp, axis=1)
    change = np.ones((B, s), bool)
    change[:, 1:] = srt[:, 1:] != srt[:, :-1]
    run_ids = np.cumsum(change, axis=1) - 1  # < s per row
    run_counts = np.bincount(
        (run_ids + np.arange(B)[:, None] * s).ravel(), minlength=B * s
    ).reshape(B, s)
    dup_rows = run_counts.max(axis=1) / s * row_scale
    dup_top_frac = float(dup_rows[live].max())

    diffs = np.diff(samp, axis=1)
    if diffs.shape[1]:
        per_row = np.mean(diffs > 0, axis=1) - np.mean(diffs < 0, axis=1)
        sortedness = float(per_row[live].mean())
    else:
        sortedness = 1.0
    return InputStats(
        n=total,
        dtype=dtype,
        sample_size=int(live.sum()) * s,
        sortedness=sortedness,
        skew=f_max_paper * nb,
        dup_top_frac=dup_top_frac,
        f_max_paper=f_max_paper,
        f_max_sampled=max(1.0 / nb, dup_top_frac),
        num_buckets=nb,
    )


# --------------------------------------------------------------------------
# Dispatch policy (pure — DESIGN.md §4 decision table)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SortPlan:
    path: str  # 'sim' | 'host' | 'dist'
    method: str  # sim/host: 'paper'|'sampled'; dist: +'hier'|'valiant'|'sample'
    capacity: int | None  # sim only: static per-bucket buffer length
    padded_n: int | None  # sim only: pow2 shape bucket the input pads to
    reason: str
    # dist only: simulated one-way gather time over the OHHC link graph
    # (repro.net, DESIGN.md §6) for this request's size — the measured-
    # timeline comm-cost estimate attached to dispatch decisions.
    comm_sim_s: float | None = None
    # Degraded serving (DESIGN.md §11): the active FaultScenario's name, and
    # — when the degraded gather is still possible — the netsim-predicted
    # gather slowdown (degraded/healthy, barrier accounting).  A fault that
    # makes the gather impossible rewrites the whole plan onto the healthy
    # host path instead and leaves fault_slowdown None.
    fault: str | None = None
    fault_slowdown: float | None = None


def autotune_capacity(
    stats: InputStats,
    method: str,
    num_buckets: int,
    padded_n: int,
    *,
    margin: float = 1.25,
) -> int:
    """Bucket capacity from the *measured* overflow model.

    Target load is ``f̂·margin·padded_n`` with ``f̂`` the measured max
    bucket fraction of the sample (for ``n ≤ sample_size`` the sample is
    the whole array, so f̂ is exact; beyond that the ×1.25 margin covers
    ~2σ of binomial sampling error for any f̂ the quantization doesn't
    already absorb — and ``SortEngine.sort``'s overflow-escalation loop
    backstops the tail, so a model miss costs a retry, never correctness).
    The legacy ``2·ceil(n/P)`` heuristic is both the floor — the
    *deterministic* answer whenever the measurement stays under it, so
    balanced traffic always lands on one capacity and one compiled
    executor — and the quantization unit above it (bounds executor-cache
    cardinality at ~P/2 steps while staying within one heuristic unit of
    the measured need).
    """
    f_hat = stats.f_max_paper if method == "paper" else stats.f_max_sampled
    base = min(partition.default_capacity(padded_n, num_buckets), padded_n)
    raw = math.ceil(f_hat * margin * padded_n)
    if raw <= base:
        return base
    cap = -(-raw // base) * base  # quantize up to a multiple of the heuristic
    cap = min(cap, padded_n + (-padded_n) % 8)
    return cap


def choose_batch_plan(
    stats: InputStats | None,
    num_buckets: int,
    padded_n: int,
    *,
    margin: float = 1.25,
    bitonic_max: int = SEGMENT_BITONIC_MAX,
    row_backend: str | None = None,
) -> SortPlan:
    """Plan ONE fused ``(B, padded_n)`` sim call for a segment batch.

    The batch twin of :func:`choose_plan`'s sim row (DESIGN.md §8): a
    homogeneous-dtype batch always takes the batched sim path — that is the
    point of coalescing — so the decisions left are the per-row kernel and
    one shared capacity:

    * rows up to ``bitonic_max`` take a bitonic method — a direct
      sentinel-padded row sort with **no** value partitioning.  At serving
      row sizes the P-way bucket machinery (O(L·P) rank matrix + scatter +
      P per-bucket sorts) costs an order of magnitude more device time than
      sorting the row outright, needs no capacity, and is immune to value
      skew — the fused batch IS the parallelism.  ``row_backend`` selects
      the kernel (:data:`ROW_BACKENDS`): ``vmap`` → ``bitonic`` (torch.sort
      over the rows), ``pallas`` → ``bitonic_pallas`` (the hand-written
      batched row kernel), ``pallas2op`` → ``bitonic2op`` (its NICE
      2-op stage); the engine feeds this from the
      :func:`choose_row_backend` measured head-to-head;
    * longer rows run the paper's bucket path: ``sampled`` splitters when
      the worst row is skewed but not duplicate-dominated (quantile
      splitters cannot split one repeated value), else the equal-width
      rule, with capacity from :func:`autotune_capacity` on the worst-row
      stats — one pathological row sizes the batch buffer rather than
      overflowing it.
    """
    if padded_n <= bitonic_max:
        backend = row_backend or "vmap"
        if backend not in _BACKEND_METHODS:
            raise ValueError(f"row_backend {backend!r} not in {ROW_BACKENDS}")
        return SortPlan(
            "sim", _BACKEND_METHODS[backend], None, padded_n,
            f"segmented bitonic rows (Lbucket={padded_n} ≤ {bitonic_max}), "
            f"row_backend={backend}",
        )
    if stats is None:
        raise ValueError("choose_batch_plan needs stats for the bucket path")
    method = "sampled" if (stats.skewed and stats.dup_top_frac <= 0.25) else "paper"
    cap = autotune_capacity(stats, method, num_buckets, padded_n, margin=margin)
    return SortPlan(
        "sim", method, cap, padded_n,
        f"segmented batch ({stats.label} worst row), capacity={cap}",
    )


def choose_plan(
    stats: InputStats,
    topo: OHHCTopology,
    *,
    mesh_devices: int = 1,
    mesh_axes: Sequence[str] = (),
    host_threshold: int = 1 << 20,
    margin: float = 1.25,
) -> SortPlan:
    """Stats × topology → (path, method, capacity).  Pure and unit-testable."""
    P = topo.total_procs
    if not kernel_keys(stats.dtype):
        # The reference sends every 64-bit key to the host because jax
        # without x64 downcasts it.  torch keeps int64 (and uint64, mapped
        # onto int64) on the device, so only keys the kernels are not built
        # for (float64 and the like) keep that rule here.
        return SortPlan(
            "host", "paper", None, None,
            f"{stats.dtype} keys: no sort kernel for this dtype, host is the exact path",
        )
    if mesh_devices > 1:
        if len(mesh_axes) >= 2:
            return SortPlan(
                "dist", "hier", None, None,
                "multi-axis mesh: cross the slow (optical) tier exactly once",
            )
        if abs(stats.sortedness) > 0.8:
            return SortPlan(
                "dist", "valiant", None, None,
                "pre-sorted input: two-hop routing kills direct-route send skew",
            )
        if stats.skewed:
            return SortPlan(
                "dist", "sample", None, None,
                "value skew: balanced sampled splitters",
            )
        return SortPlan(
            "dist", "paper", None, None,
            "uniform input: faithful equal-width splitters, no sample gather",
        )

    method = "sampled" if (stats.skewed and stats.dup_top_frac <= 0.25) else "paper"
    if stats.dup_top_frac > 0.25:
        # A dominant duplicate value defeats *every* splitter rule equally;
        # equal-width is cheaper, capacity autotune absorbs the hot bucket.
        method = "paper"
    # Host path: ragged buckets are exact under any splitter, so balanced
    # splitters buy nothing at wall-clock — equal-width ids are cheaper to
    # compute and total local-sort work is the same.  'sampled' only pays
    # on the sim path, where it prevents static-capacity blowup.
    if stats.n >= host_threshold:
        return SortPlan(
            "host", "paper", None, None,
            f"n={stats.n} ≥ host threshold: exact ragged buckets, no pad waste",
        )
    if stats.skewed and stats.n > (1 << 16):
        return SortPlan(
            "host", "paper", None, None,
            "large skewed input: dense (P, capacity) buffer would dwarf n",
        )
    padded_n = ops.bucketed_length(stats.n)
    cap = autotune_capacity(stats, method, P, padded_n, margin=margin)
    reason = f"{stats.label} input on the jit path, capacity={cap}"
    if np.dtype(stats.dtype).itemsize == 8:
        reason += (
            f"; {stats.dtype} keys stay on the device path (the reference's "
            "64-bit host rule exists only because jax without x64 downcasts)"
        )
    return SortPlan("sim", method, cap, padded_n, reason)


# --------------------------------------------------------------------------
# Padded simulated sort (the engine's executor body)
# --------------------------------------------------------------------------
_U32 = (1 << 32) - 1


def _udiv64_long(d: torch.Tensor, width) -> torch.Tensor:
    # long division over the two 32-bit halves; exact for width < 2**31
    hi = (d >> 32) & _U32
    lo = d & _U32
    q_hi = torch.div(hi, width, rounding_mode="floor")
    r_hi = hi - q_hi * width
    q_lo = torch.div((r_hi << 32) | lo, width, rounding_mode="floor")
    return (q_hi << 32) + q_lo


def _udiv64_float(d: torch.Tensor, width) -> torch.Tensor:
    # float64 estimate corrected by an integer remainder check; exact for
    # 2**31 <= width < 2**61
    hi = ((d >> 32) & _U32).to(torch.float64)
    lo = (d & _U32).to(torch.float64)
    q = torch.floor((hi * 4294967296.0 + lo) / width.to(torch.float64)).to(torch.int64)
    r = d - q * width  # the true remainder is within a few widths of [0, width)
    for _ in range(3):
        low = r < 0
        q = q - low.to(torch.int64)
        r = torch.where(low, r + width, r)
    for _ in range(3):
        high = r >= width
        q = q + high.to(torch.int64)
        r = torch.where(high, r - width, r)
    return q


def _udiv64(d: torch.Tensor, width) -> torch.Tensor:
    """Unsigned 64-bit ``d // width`` on int64 bit patterns, exactly.

    torch has no uint64 arithmetic.  Below 2**31 the divisor takes a long
    division over the two 32-bit halves (every intermediate fits int64);
    from 2**31 up (and below 2**61, which ``P ≥ 8`` guarantees) the
    quotient is under 2**33, so a float64 estimate is off by at most a few
    and an integer remainder check, in wrapping int64 arithmetic, corrects
    it.  ``width`` is an int, or an int64 tensor that broadcasts against
    ``d`` (one width per row); each width takes the rule that fits it.
    """
    if not isinstance(width, torch.Tensor):
        if width >= (1 << 61):
            raise ValueError(f"bucket width {width} needs at least 8 buckets")
        width = torch.tensor(width, dtype=torch.int64, device=d.device)
    small = width < (1 << 31)
    return torch.where(
        small,
        _udiv64_long(d, torch.where(small, width, 1)),
        _udiv64_float(d, torch.where(small, 1 << 31, width)),
    )


def _paper_ids(x_pad: torch.Tensor, valid: torch.Tensor, *, P: int) -> torch.Tensor:
    """Exact equal-width §3.1 bucket ids of the valid prefix, int32.

    Works along the last axis: ``x_pad`` is one ``(n,)`` buffer or a
    ``(B, n)`` batch, each row with its own span.  The reference works in
    uint32/uint64 with wraparound: ``width = (hi - lo) // P + 1`` and
    ``ids = (x - lo) // width`` on unsigned bit patterns, then a wrapping
    cast to int32 and a clip.  Here the per-key difference is taken modulo
    2**32 in int64 for keys up to 32 bits, or as a wrapping int64
    difference divided by :func:`_udiv64` for 64-bit keys — the same
    numbers at every position, with no sync to the host.  The numpy twin is
    ``workloads.host_bucket_ids``; the two agree bit for bit.
    """
    dtype = x_pad.dtype
    fill = torch.tensor(partition.max_sentinel(dtype), dtype=dtype, device=x_pad.device)
    low = torch.tensor(partition.min_sentinel(dtype), dtype=dtype, device=x_pad.device)
    lo = torch.where(valid, x_pad, fill).amin(dim=-1, keepdim=True)
    hi = torch.where(valid, x_pad, low).amax(dim=-1, keepdim=True)
    if not dtype.is_floating_point:
        if dtype.itemsize == 8:
            width = _udiv64(hi - lo, P) + 1
            q = _udiv64(x_pad - lo, width)
        else:
            lo = lo.to(torch.int64)
            width = torch.div((hi.to(torch.int64) - lo) & _U32, P, rounding_mode="floor") + 1
            q = torch.div((x_pad.to(torch.int64) - lo) & _U32, width, rounding_mode="floor")
        return torch.clamp(q.to(torch.int32), 0, P - 1)  # pad tail may wrap below lo
    ftype = torch.float64 if dtype == torch.float64 else torch.float32
    lo_f = lo.to(ftype)
    width = (hi.to(ftype) - lo_f) / P
    width = torch.where(width > 0, width, torch.ones_like(width))
    return torch.clamp(
        torch.floor((x_pad.to(ftype) - lo_f) / width), 0, P - 1
    ).to(torch.int32)


def _sim_sort_padded(
    x_pad: torch.Tensor,
    lens: np.ndarray,
    *,
    P: int,
    capacity: int,
    method: str,
    sample_size: int,
    local_sort: Callable[[torch.Tensor], torch.Tensor],
):
    """Sort the valid prefix of every row of a padded ``(B, n)`` batch on P
    simulated processors each.

    ``lens`` (host, ``(B,)``) holds each row's valid length.  Invalid tail
    elements route to an overflow row (bucket P) that is dropped — they
    never pollute counts or splitters.  Every row goes through the same
    launches: one count/rank and scatter for up to ``ops.MAX_BUCKETS //
    (P + 1)`` rows, one ``local_sort`` over all ``B·P`` bucket rows, one
    gather.  Returns ``(out, counts)``, ``(B, n)`` and ``(B, P)``, with row
    ``i``'s sorted valid prefix in ``out[i, :lens[i]]``.
    """
    rows, n_pad = x_pad.shape
    dtype = x_pad.dtype
    device = x_pad.device
    fill = partition.max_sentinel(dtype)
    lens_cpu = torch.from_numpy(np.asarray(lens, dtype=np.int64))
    valid = torch.arange(n_pad, device=device) < lens_cpu.to(device)[:, None]
    if method == "paper":
        ids = _paper_ids(x_pad, valid, P=P)
    elif method == "sampled":
        s = int(min(n_pad, sample_size))
        # The reference divides n_valid by s in float32; float64 would pick
        # other sample positions at some n.
        step = lens_cpu.to(torch.float32) / torch.tensor(s, dtype=torch.float32)
        idx = (torch.arange(s, dtype=torch.float32) * step[:, None]).to(torch.int64)
        idx = torch.minimum(idx, lens_cpu[:, None] - 1).clamp_min(0).to(device)
        sample = torch.sort(torch.gather(x_pad, 1, idx), dim=-1).values
        pos = torch.from_numpy((np.arange(1, P) * s) // P).to(device)
        ids = partition.splitter_bucket_ids(x_pad, sample[:, pos].contiguous())
    else:
        raise ValueError(f"unknown sim method {method!r}")
    ids = torch.where(valid, ids, P)  # row P = drop row for the pad tail
    fill_t = torch.tensor(fill, dtype=dtype, device=device)
    buckets, counts = partition.scatter_rows_to_buckets(
        torch.where(valid, x_pad, fill_t), ids, P + 1, capacity, fill_value=fill
    )
    buckets, counts = buckets[:, :P], counts[:, :P]
    buckets = local_sort(buckets.reshape(rows * P, capacity)).view(rows, P, capacity)
    out = partition.unscatter(buckets, counts, n_pad)
    return out, counts


def _sim_topk_padded(
    x_pad: torch.Tensor,
    n_valid: int,
    *,
    P: int,
    keep: int,
    capacity: int,
    local_sort: Callable[[torch.Tensor], torch.Tensor],
):
    """Partial range-partition sort: the top-k skip rule on the sim path.

    Every element is bucketed by the paper's equal-width rule, but only
    the first ``keep`` bucket rows are scattered and sorted — the
    equal-width rule orders buckets by value range, so every element of a
    bucket past the cut is ≥ every kept element and the global head of
    length ``sum(counts[:keep])`` is exact.  Buckets past the cut route to
    the drop row alongside the pad tail.  The kept rows go through ONE
    ``local_sort`` (the reference's ``jax.vmap(local_sort)``).

    Returns ``(head, counts, kept_total)``: ``kept_total`` is the
    *unclipped* kept-element count, so ``sum(counts) < kept_total`` means
    a kept bucket overflowed ``capacity`` (escalate) while
    ``kept_total < k`` means the cut was too early (widen ``keep``).
    """
    n_pad = x_pad.shape[0]
    dtype = x_pad.dtype
    fill = partition.max_sentinel(dtype)
    fill_t = torch.tensor(fill, dtype=dtype, device=x_pad.device)
    valid = torch.arange(n_pad, device=x_pad.device) < n_valid
    ids = _paper_ids(x_pad, valid, P=P)
    kept = valid & (ids < keep)
    kept_total = kept.sum()
    ids = torch.where(kept, ids, keep)  # past-the-cut + pad tail → drop row
    buckets, counts = partition.scatter_to_buckets(
        torch.where(kept, x_pad, fill_t), ids, keep + 1, capacity, fill_value=fill
    )
    buckets, counts = buckets[:keep], counts[:keep]
    buckets = local_sort(buckets)
    head = partition.unscatter(buckets, counts, min(n_pad, keep * capacity))
    return head, counts, kept_total


def _host(x) -> np.ndarray:
    """A caller's array (numpy, a tensor on any device, a list) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SortEngine runs on a CUDA device and none is available; "
            "pass device='cpu' to run the kernels' plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"SortEngine runs on cuda or cpu, not {dev}")
    return dev


def _pinned_block(n: int, dtype: torch.dtype) -> torch.Tensor:
    """``n`` keys of ``dtype`` in page-locked host memory from torch's
    caching host allocator: a block freed earlier serves a later request
    of its size, whose pages are then faulted in and locked no more.

    While the tracer records, counts the block's bytes
    (``engine.pinned_bytes``) and what the pool newly allocated for it
    (``engine.pinned_new_bytes``, also fresh host memory,
    ``engine.host_alloc_bytes``).  The pool rounds a block up to a power of
    two, so a new block can count more than was asked for.
    """
    recording = tracing.recording()
    before = _pinned_pool_bytes() if recording else 0
    block = torch.empty(n, dtype=dtype, pin_memory=True)
    if recording:
        new = _pinned_pool_bytes() - before
        tracing.count("engine.pinned_bytes", block.nbytes)
        tracing.count("engine.pinned_new_bytes", new)
        tracing.count("engine.host_alloc_bytes", new)
    return block


def _pinned_pool_bytes() -> int:
    """Bytes the caching host allocator has ever taken from CUDA."""
    return torch.cuda.host_memory_stats()["allocated_bytes.allocated"]


class _PinnedAnswers:
    """The bytes of pinned answers an engine has handed out and its callers
    still hold, kept under ``PINNED_ANSWER_CEILING``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.held = 0

    def _give_back(self, nbytes: int) -> None:
        with self._lock:
            self.held -= nbytes

    def answer(self, src: torch.Tensor) -> "np.ndarray | None":
        """``src`` (on the card) copied into a pinned block, as a numpy array
        that owns the block until its caller drops it; None past the
        ceiling."""
        nbytes = src.numel() * src.element_size()
        with self._lock:
            if self.held + nbytes > PINNED_ANSWER_CEILING:
                return None
            self.held += nbytes
        try:
            block = _pinned_block(src.numel(), src.dtype)
            block.copy_(src)
        except BaseException:
            self._give_back(nbytes)
            raise
        out = block.numpy()
        # the array holds ``out.base``, a tensor over the block, for as long
        # as it or a view of it lives
        weakref.finalize(out.base, self._give_back, nbytes)
        return out


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------
class SortEngine:
    """Auto-dispatching, capacity-autotuning sorter with a warm executor cache.

    Parameters
    ----------
    topo:            OHHC instance for the simulated/host paths (default 1-D
                     full, 36 processors).
    host_threshold:  sizes ≥ this go to the exact numpy path.
    sample_size:     stats sample size (and sampled-splitter sample cap).
    margin:          capacity safety margin.
    local_sort:      per-bucket sorter for the sim path: sorts the last axis
                     of the (rows·P, capacity) bucket buffer (default
                     ``ops.make_local_sort()``, the hand-written kernels).
    fault_scenario:  a ``repro_torch.net.faults.FaultScenario`` to serve
                     under (``None``: healthy); see ``set_fault_scenario``.
    device:          ``None`` or ``"cuda"`` runs on the card and raises when
                     there is none (with a mesh, the rank's own card,
                     ``rank % device_count`` as ``runtime.ranks.run_ranks``
                     sets it); ``"cpu"`` runs the kernels' plain versions on
                     the CPU.
    mesh/axis_names: a ``DeviceMesh`` of the ranks that call this engine
                     together (``runtime.ranks``) and the mesh dims the
                     array is sharded over; when the mesh has more than one
                     rank, ``plan`` chooses the dist path.  Its device type
                     must be the engine's.
    """

    def __init__(
        self,
        topo: OHHCTopology | None = None,
        *,
        mesh=None,
        axis_names: Sequence[str] = ("data",),
        host_threshold: int = 1 << 20,
        sample_size: int = 2048,
        margin: float = 1.25,
        local_sort: Callable[[torch.Tensor], torch.Tensor] | None = None,
        fault_scenario=None,
        device=None,
    ):
        self.device = _resolve_device(device)
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for an engine on {self.device}")
            if self.device.type == "cuda" and self.device.index is None:
                self.device = ranks.mesh_device(mesh)
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.topo = topo if topo is not None else OHHCTopology(1, "full")
        self.host_threshold = int(host_threshold)
        self.sample_size = int(sample_size)
        self.margin = float(margin)
        self.local_sort = local_sort if local_sort is not None else ops.make_local_sort()
        self.fault_scenario = fault_scenario
        self._fn_cache: dict[tuple, Callable] = {}
        self._comm_sim_cache: dict[tuple, float] = {}
        # per-scenario-name degraded classification (rebuilt rounds or the
        # GatherImpossible verdict) — warm like the caches it sits next to
        self._fault_info: dict[str, dict] = {}
        self.trace_count = 0  # executor builds (cache misses)
        self.last_report: dict | None = None
        self._pinned_answers = _PinnedAnswers()

    # ---------------------------------------------------------------- faults
    def set_fault_scenario(self, scenario) -> None:
        """Switch the engine onto (or off, with ``None``) a degraded
        topology.  Classification is cached per scenario *name*, the
        executor cache is untouched (the sorted output is
        fault-independent), and only plan pricing/pathing changes — so
        flapping scenarios never rebuild an executor (DESIGN.md §11)."""
        self.fault_scenario = scenario

    def _fault_state(self) -> "dict | None":
        """The active scenario classified: ``None`` when healthy, else a
        dict with ``impossible`` (bool), the scenario, and either the
        rebuilt degraded rounds + faulted router (possible) or the
        :class:`~repro_torch.net.faults.GatherImpossible` detail + offending
        node set (impossible)."""
        sc = self.fault_scenario
        if sc is None or not getattr(sc, "is_degraded", False):
            return None
        info = self._fault_info.get(sc.name)
        if info is None:
            from repro_torch.net.faults import GatherImpossible, degraded_gather_rounds

            try:
                rounds = degraded_gather_rounds(self.topo, sc)
            except GatherImpossible as e:
                info = {
                    "impossible": True,
                    "scenario": sc,
                    "detail": str(e),
                    "nodes": tuple(sorted(e.nodes)),
                }
            else:
                info = {
                    "impossible": False,
                    "scenario": sc,
                    "rounds": rounds,
                    "router": sc.router(self.topo),
                }
            self._fault_info[sc.name] = info
        return info

    def _apply_fault(self, plan: SortPlan, *, n: int, itemsize: int) -> SortPlan:
        """The fallback ladder (DESIGN.md §11): healthy → plan unchanged;
        degraded-but-possible → same path, gather re-priced over the
        rebuilt schedule (predicted slowdown lands in the reason and, for
        dist, in ``comm_sim_s``); impossible → the plan is rewritten onto
        the healthy host path, which needs no interconnect gather."""
        info = self._fault_state()
        if info is None:
            return plan
        name = info["scenario"].name
        if info["impossible"]:
            if plan.path == "host":
                return dataclasses.replace(
                    plan,
                    fault=name,
                    reason=f"{plan.reason}; fault={name}: degraded gather "
                    "impossible, host path unaffected",
                )
            return SortPlan(
                "host", "paper", None, None,
                f"fault={name}: degraded gather impossible "
                f"({info['detail']}); falling back to the healthy host path",
                fault=name,
            )
        healthy = self._comm_price(n, itemsize, None)
        degraded = self._comm_price(n, itemsize, info)
        ratio = degraded / healthy if healthy > 0 else 1.0
        plan = dataclasses.replace(
            plan,
            fault=name,
            fault_slowdown=ratio,
            reason=f"{plan.reason}; fault={name}: predicted "
            f"×{ratio:.2f} gather slowdown",
        )
        if plan.path == "dist":
            plan = dataclasses.replace(plan, comm_sim_s=degraded)
        return plan

    def _comm_price(self, n: int, itemsize: int, fault_info: "dict | None") -> float:
        """Barrier-mode gather time for one pow2 bucket, healthy
        (``fault_info=None``) or over a rebuilt degraded schedule — one
        cache, keyed by (bucket, itemsize, scenario name)."""
        from repro_torch.net.links import LinkModel
        from repro_torch.net.sim import simulate_gather, simulate_schedule

        bucket = ops.bucketed_length(max(2, n))
        name = None if fault_info is None else fault_info["scenario"].name
        key = ("netsim", bucket, itemsize, name)
        t = self._comm_sim_cache.get(key)
        if t is None:
            chunk = -(-bucket // self.topo.total_procs)
            if fault_info is None:
                t = simulate_gather(
                    self.topo,
                    link_model=LinkModel(),
                    chunk_sizes=chunk,
                    itemsize=itemsize,
                    barrier=True,
                ).total_time_s
            else:
                t = simulate_schedule(
                    fault_info["rounds"],
                    self.topo,
                    link_model=LinkModel(),
                    router=fault_info["router"],
                    chunk_sizes=chunk,
                    itemsize=itemsize,
                    barrier=True,
                ).total_time_s
            self._comm_sim_cache[key] = t
        return t

    def comm_cost_estimate(self, n: int, itemsize: int = 4) -> float:
        """Simulated one-way gather time (s) for an ``n``-element request.

        Runs the ``repro_torch.net`` event-driven simulator (DESIGN.md §6)
        over this engine's topology with even ``n/P`` chunks.  Cached per
        pow2 size bucket.  Under an active (and possible) fault scenario
        the price is the *degraded* schedule's (DESIGN.md §11); an
        impossible scenario prices healthy — the fallback ladder never runs
        the gather there.
        """
        info = self._fault_state()
        if info is not None and info["impossible"]:
            info = None
        return self._comm_price(n, itemsize, info)

    # -------------------------------------------------------------- planning
    def stats(self, x) -> InputStats:
        B = min(self.topo.total_procs, _MAX_STAT_BUCKETS)
        with tracing.span("engine.stats"):
            return estimate_stats(x, num_buckets=B, sample_size=self.sample_size)

    def plan(self, x, stats: InputStats | None = None) -> SortPlan:
        with tracing.span("engine.plan"):
            stats = stats if stats is not None else self.stats(x)
            plan = choose_plan(
                stats,
                self.topo,
                mesh_devices=self.mesh.size() if self.mesh is not None else 1,
                mesh_axes=self.axis_names if self.mesh is not None else (),
                host_threshold=self.host_threshold,
                margin=self.margin,
            )
            if plan.path == "dist":
                plan = dataclasses.replace(
                    plan,
                    comm_sim_s=self.comm_cost_estimate(
                        stats.n, itemsize=np.dtype(stats.dtype).itemsize
                    ),
                )
            return self._apply_fault(
                plan, n=stats.n, itemsize=np.dtype(stats.dtype).itemsize
            )

    # -------------------------------------------------------- executor cache
    def _get_sim_fn(self, padded_n: int, capacity: int, method: str, dtype, batched: bool):
        key = ("batch" if batched else "sim", padded_n, capacity, method, str(dtype))
        fn = self._fn_cache.get(key)
        if fn is not None:
            return fn
        self.trace_count += 1
        if method in BITONIC_METHODS:
            # Direct sentinel-padded row sort of a segment batch: no
            # capacity, and the counts are the rows' own lengths.
            if not batched:
                raise ValueError(f"method {method!r} is batch-only")
            if method == "bitonic":
                def fn(x_pad, lens):
                    # the ``vmap`` backend: PyTorch's library sort over the
                    # rows, whose pad cells already hold the sentinel
                    lens_t = torch.from_numpy(lens.astype(np.int32)).to(x_pad.device)
                    return torch.sort(x_pad, dim=-1).values, lens_t[:, None]
            else:
                kernel_method = "bitonic2op" if method == "bitonic2op" else "bitonic"

                def fn(x_pad, lens):
                    lens_t = torch.from_numpy(lens.astype(np.int32)).to(x_pad.device)
                    out = batched_kernels.batched_row_sort(x_pad, lens_t, method=kernel_method)
                    return out, lens_t[:, None]
        else:
            # ``sort`` runs one row, ``sort_segments`` a batch of rows: the
            # same launches either way.
            def fn(x_pad, lens):
                return _sim_sort_padded(
                    x_pad,
                    lens,
                    P=self.topo.total_procs,
                    capacity=capacity,
                    method=method,
                    sample_size=min(self.sample_size, padded_n),
                    local_sort=self.local_sort,
                )
        self._fn_cache[key] = fn
        return fn

    # ------------------------------------------------------------------ sort
    def sort(self, x, *, plan: SortPlan | None = None) -> np.ndarray:
        """Globally sort ``x``; always exact (overflow escalates capacity).

        Takes a numpy array or a tensor and returns a numpy array of the
        same dtype.  Keys must be NaN-free: NaN poisons the min/max splitter
        computation, as in every range-partitioning sort of the reference.
        """
        with tracing.span("engine.sort"):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            x_np = np.asarray(x).ravel()
            n = x_np.size
            if n <= 1:
                self.last_report = {"plan": None, "n": n, "overflow_retries": 0}
                return x_np.copy()
            stats = None
            if plan is None:
                stats = self.stats(x_np)
                plan = self.plan(x_np, stats)  # fault ladder applied inside
            else:
                # Forced plans go through the same ladder: an impossible
                # scenario rewrites even an explicit sim or dist plan onto the
                # healthy host path (DESIGN.md §11).
                plan = self._apply_fault(plan, n=n, itemsize=x_np.dtype.itemsize)
            if plan.path == "host":
                r = ohhc_sort_host(x_np, self.topo, method=plan.method)
                self.last_report = {
                    "plan": plan, "n": n, "stats": stats, "overflow_retries": 0,
                    "counts_sum": int(r.bucket_sizes.sum()),
                    "counts": np.asarray(r.bucket_sizes),
                }
                return r.sorted_array
            if plan.path == "dist":
                return self._sort_dist(x_np, plan, stats)
            return self._sort_sim(x_np, plan, stats)

    def _sort_sim(self, x_np: np.ndarray, plan: SortPlan, stats) -> np.ndarray:
        """The sim path.  On the card the keys go in and the answer comes
        out through pinned host blocks (``_pinned_block``): one host copy
        of the keys, DMA both ways, the pad tail zeroed on the card.  On
        the CPU the keys are padded on the host."""
        n = x_np.size
        padded_n = plan.padded_n or ops.bucketed_length(n)
        capacity = plan.capacity or partition.default_capacity(padded_n, self.topo.total_procs)
        pinned = self.device.type == "cuda"
        with tracing.span("engine.stage"):
            if pinned:
                block = _pinned_block(n, dtypes.key_torch_dtype(x_np.dtype))
                dtypes.to_keys(x_np, out=block.numpy())
            else:
                x_pad = np.zeros(padded_n, dtypes.key_dtype(x_np.dtype))
                keys = dtypes.to_keys(x_np)
                x_pad[:n] = keys
                tracing.count("engine.host_alloc_bytes", x_pad.nbytes)
                if keys is not x_np:  # unsigned keys: the map makes a new array
                    tracing.count("engine.host_alloc_bytes", keys.nbytes)
        with tracing.span("engine.h2d"):
            if pinned:
                xt = torch.empty(padded_n, dtype=block.dtype, device=self.device)
                xt[:n].copy_(block)  # synchronous: the block is free again on return
                xt[n:].zero_()
                del block
            else:
                xt = torch.from_numpy(x_pad).to(self.device)
        with tracing.span("engine.device_sort"):
            retries = 0
            while True:
                fn = self._get_sim_fn(padded_n, capacity, plan.method, x_np.dtype, False)
                out, counts = fn(xt[None], np.array([n]))
                got = int(counts.sum())
                if got == n:
                    break
                # Measured-model miss: escalate capacity (×2, cap at padded_n —
                # which by construction cannot overflow) and re-run.
                if capacity >= padded_n:
                    raise AssertionError("overflow with capacity == padded_n")
                capacity = min(padded_n, capacity * 2)
                capacity += (-capacity) % 8
                retries += 1
        with tracing.span("engine.d2h"):
            answer = self._pinned_answers.answer(out[0, :n]) if pinned else None
            in_place = answer is not None
            if not in_place:
                answer = out[0, :n].cpu().numpy()
                tracing.count("engine.host_alloc_bytes", answer.nbytes)
            counts_np = counts[0].cpu().numpy()
        self.last_report = {
            "plan": plan, "n": n, "stats": stats, "capacity_used": capacity,
            "counts_sum": got, "overflow_retries": retries,
            "counts": counts_np,
        }
        with tracing.span("engine.unmap"):
            y = dtypes.from_keys(answer, x_np.dtype, inplace=in_place)
            if not in_place and y is not answer:  # unsigned keys: the map back makes a new array
                tracing.count("engine.host_alloc_bytes", y.nbytes)
        return y

    # --------------------------------------------------------------- batched
    def plan_segments(self, keys, seg_lens) -> SortPlan:
        """Batch plan (method + shared capacity) for ``sort_segments`` traffic,
        without running the sort."""
        keys = np.asarray(keys).ravel()
        lens = np.asarray(seg_lens, dtype=np.int64).ravel()
        padded_n = ops.bucketed_length(int(lens.max()) if lens.size else 1)
        if padded_n > SEGMENT_BITONIC_MAX:
            padded = partition.pack_segments(keys, lens, padded_n)
            stats = estimate_batch_stats(
                padded, lens,
                num_buckets=min(self.topo.total_procs, _MAX_STAT_BUCKETS),
            )
            return choose_batch_plan(
                stats, self.topo.total_procs, padded_n, margin=self.margin
            )
        backend, detail = choose_row_backend(
            padded_n, keys.dtype, device=self.device, batch_hint=int(lens.size),
        )
        plan = choose_batch_plan(
            None, self.topo.total_procs, padded_n,
            margin=self.margin, row_backend=backend,
        )
        return dataclasses.replace(plan, reason=f"{plan.reason}; {detail}")

    def sort_segments(
        self, keys, seg_lens, *, plan: SortPlan | None = None,
        return_padded: bool = False,
    ):
        """Sort ``B`` variable-length segments in ONE padded device call.

        ``keys`` is the flat concatenation of the segments and ``seg_lens``
        their lengths.  The batch packs into one ``(B, Lbucket)``
        sentinel-padded matrix (``Lbucket`` the pow2 shape bucket of the
        longest segment, B padded to a pow2 with zero-length phantom rows),
        and one executor sorts every row.  Overflow on the bucket path
        escalates capacity ×2 exactly like ``sort``.

        Returns a list of sorted numpy segments; with ``return_padded=True``
        the ``(B, Lbucket)`` tensor on the engine's device instead (row
        ``i``'s sorted segment is ``out[i, :seg_lens[i]]``).  Keys of a
        dtype the kernels are not built for (float64 …) take an exact
        per-segment host sort and cannot honour ``return_padded``.
        """
        keys = np.asarray(keys).ravel()
        lens = np.asarray(seg_lens, dtype=np.int64).ravel()
        if (lens < 0).any():
            raise ValueError("sort_segments: negative segment length")
        if int(lens.sum()) != keys.size:
            raise ValueError(
                f"sort_segments: seg_lens sum to {int(lens.sum())} "
                f"but keys has {keys.size} elements"
            )
        B = int(lens.size)
        total = keys.size
        max_n = int(lens.max()) if B else 0
        if not kernel_keys(keys.dtype):
            if return_padded:
                raise ValueError(
                    f"return_padded needs the device path; {keys.dtype} keys "
                    "only have the exact host fallback"
                )
            outs = [
                np.sort(seg)
                for seg in np.split(keys, np.cumsum(lens)[:-1])
            ] if B else []
            self.last_report = {
                "plan": SortPlan(
                    "host", "paper", None, None,
                    f"{keys.dtype} segments: no sort kernel for this dtype, "
                    "exact host fallback",
                ),
                "n": total, "batch": B, "overflow_retries": 0,
            }
            return outs
        fault_info = self._fault_state()
        if fault_info is not None and fault_info["impossible"]:
            # An impossible scenario has no degraded gather to run, so the
            # batch is served exactly on the host, and no kernel launches
            # (DESIGN.md §11).
            if return_padded:
                raise ValueError(
                    "return_padded needs the device path; fault scenario "
                    f"{fault_info['scenario'].name!r} makes the degraded "
                    "gather impossible and forces the host fallback"
                )
            outs = [
                np.sort(seg)
                for seg in np.split(keys, np.cumsum(lens)[:-1])
            ] if B else []
            self.last_report = {
                "plan": SortPlan(
                    "host", "paper", None, None,
                    f"fault={fault_info['scenario'].name}: degraded gather "
                    f"impossible ({fault_info['detail']}); exact host fallback",
                    fault=fault_info["scenario"].name,
                ),
                "n": total, "batch": B, "overflow_retries": 0,
            }
            return outs
        padded_n = ops.bucketed_length(max(max_n, 1))
        if B == 0 or max_n <= 1:
            # Nothing to sort row-wise; keep the trivial case off the device.
            self.last_report = {
                "plan": SortPlan("sim", "paper", None, padded_n, "trivial batch"),
                "n": total, "batch": B, "overflow_retries": 0,
            }
            packed = partition.pack_segments(keys, lens, padded_n)
            if return_padded:
                return dtypes.to_user_tensor(
                    dtypes.to_device(packed, self.device), keys.dtype
                )
            return partition.unpack_segments(packed, lens)
        # Pad B to a pow2 with zero-length phantom rows so a stream of
        # batch sizes reuses a handful of shapes; serving-size (bitonic)
        # rows get a floor of 8.
        b_floor = 3 if padded_n <= SEGMENT_BITONIC_MAX else 0
        B_pad = 1 << max(int(B - 1).bit_length(), b_floor)
        lens_pad = np.zeros(B_pad, np.int64)
        lens_pad[:B] = lens
        padded = partition.pack_segments(keys, lens_pad, padded_n)
        stats = None
        if plan is None:
            if padded_n <= SEGMENT_BITONIC_MAX:
                backend, detail = choose_row_backend(
                    padded_n, keys.dtype, device=self.device, batch_hint=B_pad,
                )
                plan = choose_batch_plan(
                    None, self.topo.total_procs, padded_n,
                    margin=self.margin, row_backend=backend,
                )
                plan = dataclasses.replace(plan, reason=f"{plan.reason}; {detail}")
            else:
                stats = estimate_batch_stats(
                    padded, lens_pad,
                    num_buckets=min(self.topo.total_procs, _MAX_STAT_BUCKETS),
                )
                plan = choose_batch_plan(
                    stats, self.topo.total_procs, padded_n, margin=self.margin
                )
        # Degraded-but-possible scenario: same path, plan annotated with
        # the predicted gather slowdown (impossible was served above).
        plan = self._apply_fault(plan, n=max(total, 1), itemsize=keys.dtype.itemsize)
        if plan.path != "sim":
            raise ValueError(f"sort_segments only runs the sim path, got {plan.path!r}")
        method = plan.method
        capacity = 0 if method in BITONIC_METHODS else (
            plan.capacity
            or partition.default_capacity(padded_n, self.topo.total_procs)
        )
        xt = dtypes.to_device(padded, self.device)
        retries = 0
        while True:
            fn = self._get_sim_fn(padded_n, capacity, method, keys.dtype, True)
            out, counts = fn(xt, lens_pad)
            per_row = counts.sum(dim=-1).cpu().numpy()
            if np.array_equal(per_row, lens_pad):
                break
            if capacity >= padded_n:
                raise AssertionError("overflow with capacity == padded_n")
            capacity = min(padded_n, capacity * 2)
            capacity += (-capacity) % 8
            retries += 1
        self.last_report = {
            "plan": dataclasses.replace(
                plan, capacity=capacity if method not in BITONIC_METHODS else None
            ),
            "n": total, "stats": stats, "batch": B, "batch_padded": B_pad,
            "overflow_retries": retries,
            "pad_cells": B * padded_n - total,
        }
        if return_padded:
            return dtypes.to_user_tensor(out[:B], keys.dtype)
        return partition.unpack_segments(dtypes.to_numpy(out[:B], keys.dtype), lens)

    def sort_many(self, xs: Sequence) -> list[np.ndarray]:
        """Sort a batch of arrays with ONE batched executor (a thin wrapper
        over ``sort_segments``)."""
        arrs = [np.asarray(a).ravel() for a in xs]
        if not arrs:
            return []
        dtype = arrs[0].dtype
        if any(a.dtype != dtype for a in arrs):
            raise ValueError("sort_many requires a homogeneous dtype batch")
        lens = [a.size for a in arrs]
        if max(lens) <= 1:
            return [a.copy() for a in arrs]
        flat = np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
        return self.sort_segments(flat, lens)

    # ----------------------------------------------------------------- pairs
    def sort_pairs(self, keys, vals):
        """Key/payload sort — flat arrays on the pair kernel, pytrees via
        a permutation gather.

        A single flat 1-D payload (numpy array or tensor) takes the tagged
        bitonic pair kernel directly and returns ``(keys, vals)`` as
        tensors on the engine's device, keys in the caller's dtype (the
        serving hot path: length-ordering a request batch).  Any other
        payload pytree (dicts, lists, tuples, ``None``; multi-dim leaves,
        mixed dtypes) rides :meth:`argsort_keys`: the same kernel sorts
        ``(key, index)`` once, then every leaf is gathered by the
        permutation on the host, byte-exact for every leaf dtype.  Returns
        ``(sorted_keys, same-structure payload)`` as numpy.
        """
        if pytree.is_leaf(vals) and _ndim(vals) == 1:
            return self._sort_pairs_flat(keys, vals)
        return self._sort_pairs_tree(keys, vals)

    def _sort_pairs_flat(self, keys, vals):
        """The flat path: one payload array through the tagged pair kernel
        (``ops.local_sort_pairs`` pads to the shape bucket and tags the
        valid length, so pad zeros never displace real payloads on
        dtype-max key ties)."""
        if isinstance(vals, torch.Tensor):
            vt = vals.detach().reshape(-1).to(self.device)
        else:
            vt = torch.from_numpy(np.ascontiguousarray(np.asarray(vals).ravel())).to(self.device)
        if isinstance(keys, torch.Tensor) and keys.dtype in bitonic.DTYPE_CODES:
            k_np, key_dtype = None, np.dtype(str(keys.dtype).removeprefix("torch."))
            kt = keys.detach().reshape(-1).to(self.device)
        else:
            k_np = _host(keys).ravel()
            key_dtype = k_np.dtype
            kt = dtypes.to_device(k_np, self.device) if kernel_keys(key_dtype) else None
        n = kt.shape[0] if kt is not None else k_np.size
        if vt.shape[0] != n:
            raise ValueError(f"sort_pairs: {n} keys but {vt.shape[0]} payload values")
        if n <= 1:
            if kt is None:
                return torch.from_numpy(k_np).to(self.device), vt
            return dtypes.to_user_tensor(kt, key_dtype), vt
        n_pad = ops.bucketed_length(n)
        if n_pad > ops.MAX_TILE:
            # the reference pre-pads, so its message names the padded length
            raise ValueError(f"local_sort_pairs supports n ≤ {ops.MAX_TILE}, got {n_pad}")
        if kt is None:
            # keys no pair kernel takes (float64, float16, …): the host
            # stable argsort, its permutation gathered on the device
            ks, perm = self.argsort_keys(k_np)
            return torch.from_numpy(ks).to(self.device), vt[torch.from_numpy(perm).to(self.device)]
        ks, vs = ops.local_sort_pairs(kt, vt)
        return dtypes.to_user_tensor(ks, key_dtype), vs

    def argsort_keys(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """``(sorted_keys, permutation)`` with ``sorted_keys == keys[perm]``.

        The permutation comes from the tagged pair kernel sorting
        ``(key, arange)`` on the engine's device — 64-bit integer keys
        included.  Keys of a dtype no kernel takes (float64, float16, …)
        and arrays past ``ops.MAX_TILE`` take the host stable argsort.
        Takes numpy or a tensor; returns numpy.
        """
        keys_np = _host(keys).ravel()
        n = keys_np.size
        if n <= 1:
            return keys_np.copy(), np.arange(n, dtype=np.int64)
        if not kernel_keys(keys_np.dtype) or ops.bucketed_length(n) > ops.MAX_TILE:
            perm = np.argsort(keys_np, kind="stable")
            why = (
                "(x64/tile exactness rule)" if kernel_keys(keys_np.dtype)
                else "(no pair kernel for this dtype)"
            )
            self.last_report = {
                "plan": SortPlan(
                    "host", "pairs", None, None,
                    f"argsort: {keys_np.dtype} n={n} host stable argsort {why}",
                ),
                "n": n, "overflow_retries": 0, "counts_sum": n,
            }
            return keys_np[perm], perm
        kt = dtypes.to_device(keys_np, self.device)
        ks, perm = ops.local_sort_pairs(kt, torch.arange(n, dtype=torch.int32, device=self.device))
        self.last_report = {
            "plan": SortPlan(
                "sim", "pairs", None, ops.bucketed_length(n),
                f"argsort: tagged pair kernel over (key, arange), n={n}",
            ),
            "n": n, "overflow_retries": 0, "counts_sum": n,
        }
        return dtypes.to_numpy(ks, keys_np.dtype), perm.cpu().numpy().astype(np.int64)

    def _sort_pairs_tree(self, keys, vals):
        """Pytree payload path: one key argsort, then a host gather of
        every leaf along its leading axis (byte-exact)."""
        keys_np = _host(keys).ravel()
        n = keys_np.size
        index = itertools.count()

        def checked(leaf):
            leaf, i = _host(leaf), next(index)
            if leaf.ndim < 1 or leaf.shape[0] != n:
                raise ValueError(
                    f"sort_pairs: payload leaf {i} has shape {leaf.shape}; "
                    f"leading dim must equal n={n}"
                )
            return leaf

        tree = pytree.tree_map(checked, vals)
        if n <= 1:
            return keys_np.copy(), pytree.tree_map(np.copy, tree)
        ks, perm = self.argsort_keys(keys_np)
        return ks, pytree.tree_map(lambda leaf: leaf[perm], tree)

    # ----------------------------------------------------------------- top-k
    def _check_top_k(self, n: int, k) -> int:
        if isinstance(k, bool) or not isinstance(k, (int, np.integer)):
            raise TypeError(f"top_k: k must be an int, got {type(k).__name__}")
        k = int(k)
        if k < 0:
            raise ValueError(f"top_k: k must be >= 0, got {k}")
        if k > n:
            raise TopKTooLarge(f"top_k: k={k} exceeds n={n}")
        return k

    def _plan_top_k_info(self, x_np: np.ndarray, k: int):
        """Plan + exact skip/capacity accounting for one top-k request.

        One O(n) host histogram under the exact kernel bucket rule
        (``workloads.host_bucket_ids``) yields the cut bucket, the
        skipped-bucket count, and a capacity sized to the KEPT buckets
        only.  Keys of a dtype no kernel takes go to the host head; 64-bit
        integer keys stay on the sim path, as in ``choose_plan``.
        """
        n = x_np.size
        P = self.topo.total_procs
        ids = workloads.host_bucket_ids(x_np, P)
        counts = np.bincount(ids, minlength=P)
        keep, skipped = workloads.topk_cut(counts, k)
        kept_count = int(counts[:keep].sum())
        # The executed kept prefix is the pow2 ceiling of the exact cut
        # (capped at P), so nearby cuts share one executor.
        keep_exec = min(P, 1 << int(keep - 1).bit_length())
        padded_n = ops.bucketed_length(n)
        if (
            not kernel_keys(x_np.dtype)
            or n >= self.host_threshold
            or kept_count <= n // 4
        ):
            # Small heads (or no kernel for the dtype): the host executor
            # sorts only the kept prefix.
            plan = SortPlan(
                "host", "topk", None, None,
                f"top_k k={k}: skipped={skipped}/{P} buckets past the cut, "
                f"kept {kept_count}/{n} keys; exact host head",
            )
        else:
            cap = max(int(counts[:keep_exec].max()), 8)
            cap += (-cap) % 8
            cap = min(cap, padded_n + (-padded_n) % 8)
            plan = SortPlan(
                "sim", "topk", cap, padded_n,
                f"top_k k={k}: skipped={P - keep_exec}/{P} buckets past the "
                f"cut (exact cut {keep}, pow2 exec {keep_exec}), kept-bucket "
                f"capacity={cap}",
            )
        plan = self._apply_fault(plan, n=n, itemsize=x_np.dtype.itemsize)
        info = {
            "keep": keep,
            "keep_exec": keep_exec,
            "skipped": skipped,
            "kept_count": kept_count,
            "counts": counts,
        }
        return plan, info

    def plan_top_k(self, x, k) -> SortPlan:
        """The top-k dispatch decision without executing it."""
        x_np = _host(x).ravel()
        k = self._check_top_k(x_np.size, k)
        if k == 0 or x_np.size <= 1:
            return SortPlan(
                "host", "topk", None, None, f"top_k k={k}: trivial head"
            )
        return self._plan_top_k_info(x_np, k)[0]

    def top_k(self, x, k, *, plan: SortPlan | None = None) -> np.ndarray:
        """The sorted head ``np.sort(x)[:k]`` without sorting past rank k.

        Reuses the bucket machinery: the equal-width rule orders buckets
        by value range, so once the cumulative bucket histogram covers
        ``k`` every later bucket is wholly past the head and is skipped
        (``SortPlan.reason`` reports the skipped-bucket count).  Always
        exact, ties at rank k included.  ``k > n`` raises
        :class:`~repro_torch.core.workloads.TopKTooLarge`.  Takes numpy or
        a tensor; returns numpy.
        """
        x_np = _host(x).ravel()
        n = x_np.size
        k = self._check_top_k(n, k)
        P = self.topo.total_procs
        if k == 0 or n == 0:
            self.last_report = {
                "plan": None, "n": n, "k": k, "overflow_retries": 0,
                "skipped_buckets": P, "kept_count": 0,
            }
            return x_np[:0].copy()
        if n <= 1:
            self.last_report = {
                "plan": None, "n": n, "k": k, "overflow_retries": 0,
                "skipped_buckets": 0, "kept_count": n,
            }
            return x_np.copy()
        auto_plan, info = self._plan_top_k_info(x_np, k)
        if plan is None:
            plan = auto_plan
        else:
            plan = self._apply_fault(plan, n=n, itemsize=x_np.dtype.itemsize)
        if plan.path != "sim":
            head, hinfo = workloads.host_top_k(x_np, k, P)
            self.last_report = {
                "plan": plan, "n": n, "k": k, "overflow_retries": 0,
                "skipped_buckets": hinfo["skipped_buckets"],
                "kept_count": hinfo["kept_count"],
                "counts_sum": hinfo["kept_count"],
            }
            return head
        padded_n = plan.padded_n or ops.bucketed_length(n)
        capacity = plan.capacity or partition.default_capacity(padded_n, P)
        keep = info["keep_exec"]
        x_pad = np.zeros(padded_n, dtypes.key_dtype(x_np.dtype))
        x_pad[:n] = dtypes.to_keys(x_np)
        xt = torch.from_numpy(x_pad).to(self.device)
        retries = 0
        while True:
            fn = self._get_topk_fn(padded_n, capacity, keep, x_np.dtype)
            head_pad, counts, kept_total = fn(xt, n)
            kept_total = int(kept_total)
            got = int(counts.sum())
            if got < kept_total:
                # A kept bucket overflowed its (kept-only) capacity:
                # escalate ×2 exactly like sort's retry loop.
                if capacity >= padded_n:
                    raise AssertionError("overflow with capacity == padded_n")
                capacity = min(padded_n, capacity * 2)
                capacity += (-capacity) % 8
                retries += 1
                continue
            if kept_total < k:
                # A forced/stale plan cut too early: widen the kept prefix.
                if keep >= P:
                    raise AssertionError("top_k cut miss with keep == P")
                keep = min(P, keep * 2)
                retries += 1
                continue
            break
        self.last_report = {
            "plan": plan, "n": n, "k": k, "capacity_used": capacity,
            "skipped_buckets": P - keep, "kept_count": kept_total,
            "counts_sum": got, "overflow_retries": retries,
            "counts": counts.cpu().numpy(),
        }
        return dtypes.to_numpy(head_pad[:k], x_np.dtype)

    def _get_topk_fn(self, padded_n: int, capacity: int, keep: int, dtype):
        key = ("topk", padded_n, capacity, keep, str(dtype))
        fn = self._fn_cache.get(key)
        if fn is None:
            self.trace_count += 1

            def fn(x_pad, n_valid):
                return _sim_topk_padded(
                    x_pad, n_valid, P=self.topo.total_procs, keep=keep,
                    capacity=capacity, local_sort=self.local_sort,
                )

            self._fn_cache[key] = fn
        return fn

    # ----------------------------------------------------------------- merge
    def merge_sorted(self, sorted_buf, new_keys) -> np.ndarray:
        """Fold ``new_keys`` into an already-sorted buffer incrementally.

        The increment goes through the full engine dispatch (``sort``)
        and the two ascending runs fuse in O(n + m) with the host
        ``searchsorted`` gather.  The buffer must already be ascending
        (validated, O(n)); dtype mismatches are a typed error, never a
        silent cast.  Takes numpy or tensors; returns numpy.
        """
        buf = _host(sorted_buf).ravel()
        new = _host(new_keys).ravel()
        if buf.dtype != new.dtype:
            raise ValueError(
                f"merge_sorted: dtype mismatch — buffer {buf.dtype} "
                f"vs new keys {new.dtype}"
            )
        if not workloads.check_sorted(buf):
            raise ValueError(
                "merge_sorted: sorted_buf is not ascending — sort it first"
            )
        if new.size == 0:
            self.last_report = {
                "plan": SortPlan(
                    "host", "merge", None, None,
                    f"merge: empty increment onto |buf|={buf.size}",
                ),
                "n": buf.size, "overflow_retries": 0,
                "counts_sum": buf.size, "merged_new": 0,
            }
            return buf.copy()
        inner_plan = None
        retries = 0
        if new.size > 1:
            new_sorted = self.sort(new)  # full dispatch for the increment
            inner = self.last_report or {}
            inner_plan = inner.get("plan")
            retries = int(inner.get("overflow_retries", 0))
        else:
            new_sorted = new
        out = workloads.merge_sorted_arrays(buf, new_sorted)
        plan = SortPlan(
            "host", "merge", None, None,
            f"merge: |buf|={buf.size} reused sorted, |new|={new.size} "
            f"engine-sorted ({getattr(inner_plan, 'path', 'trivial')}"
            f"/{getattr(inner_plan, 'method', '-')}), "
            "O(n+m) searchsorted gather",
        )
        self.last_report = {
            "plan": plan, "n": out.size, "overflow_retries": retries,
            "counts_sum": out.size, "merged_new": int(new.size),
            "inner_plan": inner_plan,
        }
        return out

    # ------------------------------------------------------------------ dist
    def _sort_dist(self, x_np: np.ndarray, plan: SortPlan, stats) -> np.ndarray:
        """``dist_sort`` over the mesh, escalating the capacity factor on
        overflow; every rank gets the whole sorted array."""
        if self.mesh is None:
            raise ValueError("a dist plan needs SortEngine(mesh=...)")
        if stats is None:
            stats = self.stats(x_np)
        sizes = ranks.mesh_sizes(self.mesh)
        num_shards = math.prod(sizes[ax] for ax in self.axis_names)
        n = x_np.size
        pad = (-n) % num_shards
        if pad:
            fill = (
                np.iinfo(x_np.dtype).max
                if np.issubdtype(x_np.dtype, np.integer)
                else np.inf
            )
            x_np = np.concatenate([x_np, np.full(pad, fill, x_np.dtype)])
        f_hat = stats.f_max_sampled if plan.method != "paper" else stats.f_max_paper
        cf = max(2.0, self.margin * f_hat * num_shards * 2.0)
        keys = dtypes.to_keys(x_np)
        group = ranks.axis_group(self.mesh, self.axis_names)
        retries = 0
        while True:
            vals, count = dist_sort_keys(
                keys, x_np.dtype, mesh=self.mesh, axis_names=self.axis_names,
                method=plan.method, capacity_factor=cf, local_sort=self.local_sort,
                device=self.device,
            )
            counts = ranks.all_gather(count.new_empty(num_shards), count, group).cpu().numpy()
            if int(counts.sum()) == x_np.size:
                break
            # Overflow drops elements (dist_sort contract); escalate like
            # the sim path.  cf == num_shards cannot overflow: every dest
            # row then holds a sender's whole shard.
            if cf >= num_shards:
                raise AssertionError("dist overflow at capacity_factor == shards")
            cf = min(float(num_shards), cf * 2.0)
            retries += 1
        # every rank reads the global array, as a jax process does
        shards = ranks.all_gather(vals.new_empty(num_shards * vals.shape[0]), vals, group)
        shards = shards.cpu().numpy().reshape(num_shards, -1)
        out = np.concatenate([sh[: int(c)] for sh, c in zip(shards, counts)])
        self.last_report = {
            "plan": plan, "n": n, "stats": stats,
            # counts includes the shard-divisibility pad (max-sentinel
            # elements that sort to the tail and are sliced off below);
            # report caller elements so conservation means counts_sum == n.
            "counts_sum": int(counts.sum()) - pad, "overflow_retries": retries,
            "capacity_factor": cf,
            "comm_sim_s": (
                plan.comm_sim_s
                if plan.comm_sim_s is not None
                else self.comm_cost_estimate(n, itemsize=x_np.dtype.itemsize)
            ),
        }
        return dtypes.from_keys(out[:n], x_np.dtype)
