"""Paper-faithful parallel Quick Sort on the OHHC (§3), torch port.

Counterpart of ``repro.core.ohhc_sort``:

* ``ohhc_sort_sim`` — simulated-processor path: the ``total_procs``
  processors are axis 0 of a dense (P, capacity) bucket buffer, and one
  ``local_sort`` call sorts every bucket row (the hand-written bitonic
  kernels by default).
* ``ohhc_sort_host`` — numpy orchestration at full paper sizes with exact
  ragged buckets and per-bucket timing (a copy of the reference's).
* ``LinkModel`` / ``model_comm_time_s`` — the store-and-forward cost model
  (copies).
* ``QuickSortCounters`` / ``quicksort_counters`` /
  ``parallel_quicksort_counters`` / ``bitonic_counters`` — the
  instrumented Quick Sort of the paper's Figs 6.20–6.24 (numpy copies).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import partition
from repro_torch.core.schedule import AccumulationSchedule, payload_bytes_per_round
from repro_torch.core.topology import OHHCTopology
from repro_torch.kernels import ops


# --------------------------------------------------------------------------
# Communication cost model (store-and-forward, Theorem 6 semantics)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-link-class bandwidth/latency.  Defaults ≈ TPU v5e ICI vs inter-pod.

    The paper's conclusion laments that "the difference in the speed of the
    electrical and optical connections ... was not taken into consideration"
    — we model it explicitly.
    """

    electrical_gbps: float = 50.0  # intra-pod ICI, GB/s per link
    optical_gbps: float = 25.0  # inter-pod, GB/s per link
    alpha_us: float = 1.0  # per-message latency, microseconds

    def round_time_s(self, link: str, max_msg_bytes: int) -> float:
        bw = self.electrical_gbps if link == "electrical" else self.optical_gbps
        return self.alpha_us * 1e-6 + max_msg_bytes / (bw * 1e9)


def model_comm_time_s(
    schedule: AccumulationSchedule,
    chunk_sizes: "list[int] | np.ndarray",
    link_model: LinkModel = LinkModel(),
    itemsize: int = 4,
    roundtrip: bool = True,
) -> float:
    """Critical-path communication time: each round costs its largest message."""
    rounds = payload_bytes_per_round(schedule, list(chunk_sizes), itemsize)
    t = sum(link_model.round_time_s(r["link"], r["max_msg_bytes"]) for r in rounds)
    return 2.0 * t if roundtrip else t


# --------------------------------------------------------------------------
# Simulated path
# --------------------------------------------------------------------------
def ohhc_sort_sim(
    x: torch.Tensor,
    topo: OHHCTopology,
    *,
    capacity: int | None = None,
    method: str = "paper",
    local_sort: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort ``x`` with the paper's algorithm on a simulated processor axis.

    Returns ``(sorted_x, bucket_counts)``.  ``method='paper'`` uses the §3.1
    equal-width ranges; ``method='sampled'`` balanced splitters.
    ``capacity`` defaults to ``2 * ceil(n / P)`` rounded up to 8.
    ``local_sort`` sorts the last axis of the (P, capacity) buffer
    (default: the bitonic kernels, ``ops.local_sort``).
    """
    x = x.reshape(-1)
    n = x.shape[0]
    P = topo.total_procs
    if capacity is None:
        capacity = partition.default_capacity(n, P)
    if method == "paper":
        ids = partition.paper_bucket_ids(x, P)
    elif method == "sampled":
        spl = partition.sampled_splitters(x, P)
        ids = partition.splitter_bucket_ids(x, spl)
    else:
        raise ValueError(f"unknown method {method!r}")
    buckets, counts = partition.scatter_to_buckets(x, ids, P, capacity)
    if local_sort is None:
        local_sort = ops.local_sort
    buckets = local_sort(buckets)
    out = partition.unscatter(buckets, counts, n)
    return out, counts


# --------------------------------------------------------------------------
# Host (numpy) path at paper scale, with per-bucket timing
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HostSortResult:
    sorted_array: np.ndarray
    bucket_sizes: np.ndarray  # (total_procs,)
    local_sort_times_s: np.ndarray  # (total_procs,)
    partition_time_s: float
    comm_model_time_s: float
    paper_steps: int
    tree_sends: int
    critical_rounds: int

    @property
    def t_parallel_model_s(self) -> float:
        """Paper's 'last thread finish' analogue: slowest local sort + comm."""
        return float(self.local_sort_times_s.max()) + self.comm_model_time_s


def ohhc_sort_host(
    x: np.ndarray,
    topo: OHHCTopology,
    *,
    method: str = "paper",
    link_model: LinkModel = LinkModel(),
) -> HostSortResult:
    """Full-size numpy execution of the algorithm with exact ragged buckets."""
    x = np.asarray(x).ravel()
    P = topo.total_procs
    t0 = time.perf_counter()
    if method == "paper":
        lo, hi = x.min(), x.max()
        width = (float(hi) - float(lo)) / P
        if width <= 0:
            ids = np.zeros(x.shape, np.int64)
        else:
            # float64 difference: narrow signed dtypes (int8 spanning the
            # negative range) would wrap under native-dtype subtraction.
            ids = np.clip(
                ((x.astype(np.float64) - float(lo)) / width).astype(np.int64),
                0, P - 1,
            )
    elif method == "sampled":
        s = min(x.size, 32 * P)
        sample = np.sort(x[:: -(-x.size // s)])
        splitters = sample[(np.arange(1, P) * sample.size) // P]
        ids = np.searchsorted(splitters, x, side="right")
    else:
        raise ValueError(method)
    order = np.argsort(ids, kind="stable")
    sizes = np.bincount(ids, minlength=P)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    gathered = x[order]
    t_partition = time.perf_counter() - t0

    times = np.zeros(P)
    out = np.empty_like(x)
    for p in range(P):
        seg = gathered[bounds[p] : bounds[p + 1]]
        t1 = time.perf_counter()
        out[bounds[p] : bounds[p + 1]] = np.sort(seg, kind="quicksort")
        times[p] = time.perf_counter() - t1

    sched = AccumulationSchedule.build(topo)
    comm = model_comm_time_s(sched, sizes, link_model, itemsize=x.dtype.itemsize)
    return HostSortResult(
        sorted_array=out,
        bucket_sizes=sizes,
        local_sort_times_s=times,
        partition_time_s=t_partition,
        comm_model_time_s=comm,
        paper_steps=sched.paper_step_count(),
        tree_sends=sched.roundtrip_send_count(),
        critical_rounds=sched.critical_path_rounds(),
    )


# --------------------------------------------------------------------------
# Instrumented sequential Quick Sort (Figs 6.20–6.24 counters)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class QuickSortCounters:
    recursion_calls: int = 0
    iterations: int = 0  # element visits during partitioning ("comparisons")
    swaps: int = 0

    def __iadd__(self, o: "QuickSortCounters"):
        self.recursion_calls += o.recursion_calls
        self.iterations += o.iterations
        self.swaps += o.swaps
        return self


def quicksort_counters(x: np.ndarray, *, pivot: str = "middle") -> QuickSortCounters:
    """Count recursion calls / iterations / swaps of Quick Sort.

    Middle-element pivot (the paper's sequential runs are *faster* on
    sorted/reverse-sorted inputs — Fig 6.1 — which rules out first/last
    pivots).  Iterations: m−1 element visits per partition of a length-m
    segment.  Swaps: **Hoare pair-exchange semantics** — one swap per
    element initially in the left zone that belongs right (each pairs with
    a misplaced right element); an already-sorted segment costs 0 swaps,
    reproducing the paper's Fig 6.22 sorted≪random gap.
    Segment loop is Python-level; use reduced sizes for quick runs.
    """
    x = np.asarray(x).copy()
    c = QuickSortCounters()
    stack = [(0, x.size)]
    while stack:
        lo, hi = stack.pop()
        m = hi - lo
        if m <= 1:
            continue
        c.recursion_calls += 1
        seg = x[lo:hi]
        if pivot == "middle":
            pi = m // 2
        elif pivot == "last":
            pi = m - 1
        else:
            raise ValueError(pivot)
        pv = seg[pi]
        c.iterations += m - 1
        less = seg < pv
        n_less = int(less.sum())
        # Hoare semantics: each element sitting in the final left zone that
        # is NOT < pivot must be exchanged with a misplaced right element.
        c.swaps += int((~less[:n_less]).sum())
        # Stable reconstruction of the partition result (counts are what we
        # need; actual element order within halves doesn't change counts of
        # subsequent *middle*-pivot partitions in expectation, but we keep
        # the true partition layout for exactness).
        geq = ~less
        geq[pi] = False
        x[lo : lo + n_less] = seg[less]
        x[lo + n_less] = pv
        x[lo + n_less + 1 : hi] = seg[geq]
        stack.append((lo, lo + n_less))
        stack.append((lo + n_less + 1, hi))
    return c


def parallel_quicksort_counters(
    x: np.ndarray, topo: OHHCTopology, *, method: str = "paper"
) -> QuickSortCounters:
    """Counters summed over all per-processor bucket sorts (Figs 6.20–6.22)."""
    x = np.asarray(x).ravel()
    P = topo.total_procs
    if method == "paper":
        lo, hi = x.min(), x.max()
        width = (float(hi) - float(lo)) / P
        ids = (
            np.zeros(x.shape, np.int64)
            if width <= 0
            else np.clip(
                ((x.astype(np.float64) - float(lo)) / width).astype(np.int64),
                0, P - 1,
            )
        )
    else:
        s = min(x.size, 32 * P)
        sample = np.sort(x[:: -(-x.size // s)])
        splitters = sample[(np.arange(1, P) * sample.size) // P]
        ids = np.searchsorted(splitters, x, side="right")
    order = np.argsort(ids, kind="stable")
    sizes = np.bincount(ids, minlength=P)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    gathered = x[order]
    total = QuickSortCounters()
    for p in range(P):
        total += quicksort_counters(gathered[bounds[p] : bounds[p + 1]])
    return total


def bitonic_counters(n: int) -> dict:
    """Closed-form compare counts for the TPU-native bitonic local sort."""
    k = max(int(np.ceil(np.log2(max(n, 1)))), 0)
    stages = k * (k + 1) // 2
    return {
        "stages": stages,
        "comparisons": stages * (1 << k) // 2,
        "padded_n": 1 << k,
    }
