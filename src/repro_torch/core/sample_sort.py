"""Distributed sample sort: the cost model and the host reference.

The port's copy of ``repro.core.sample_sort`` (numpy and Python, no
tensors).  The sort over real ranks lives in ``repro_torch.core.dist_sort``;
here are the analytic all-to-all cost on a two-tier network, which the
comm-steps benchmark sets against the paper's spanning-tree schedule, and
a host reference of the sampled-splitter exchange.

What it changes against the paper's algorithm (DESIGN.md §2): balanced
sampled splitters instead of equal-width ranges; one fused exchange
instead of the store-and-forward spanning tree, with the result left
sharded; and on a multi-pod mesh, the intra-pod exchange first and one
crossing of the inter-pod tier.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.ohhc_sort import LinkModel, model_comm_time_s
from repro_torch.core.schedule import AccumulationSchedule
from repro_torch.core.topology import OHHCTopology


@dataclasses.dataclass(frozen=True)
class ExchangeModel:
    """All-to-all cost on a two-tier network.

    Per device: sends (P−1)/P of its n/P elements.  Intra-pod traffic rides
    electrical links; the inter-pod fraction crosses the optical tier once.
    """

    link: LinkModel = LinkModel()

    def all_to_all_time_s(
        self,
        n_total: int,
        itemsize: int,
        devices: int,
        pods: int = 1,
    ) -> float:
        per_dev = n_total / devices
        send_bytes = per_dev * (devices - 1) / devices * itemsize
        if pods <= 1:
            return self.link.alpha_us * 1e-6 + send_bytes / (
                self.link.electrical_gbps * 1e9
            )
        # two-level: intra-pod portion + one inter-pod crossing
        inter_frac = (pods - 1) / pods
        intra = send_bytes * (1 - inter_frac) / (self.link.electrical_gbps * 1e9)
        inter = send_bytes * inter_frac / (self.link.optical_gbps * 1e9)
        return 2 * self.link.alpha_us * 1e-6 + intra + inter


def sample_sort_host(x: np.ndarray, num_shards: int, *, oversample: int = 32):
    """Host reference: returns (shards list, splitters).  Each shard sorted,
    shard i's max ≤ shard i+1's min; concatenation is the sorted array."""
    x = np.asarray(x).ravel()
    s = min(x.size, oversample * num_shards)
    sample = np.sort(x[:: -(-x.size // s)])
    splitters = sample[(np.arange(1, num_shards) * sample.size) // num_shards]
    ids = np.searchsorted(splitters, x, side="right")
    shards = [np.sort(x[ids == i], kind="quicksort") for i in range(num_shards)]
    return shards, splitters


def imbalance(bucket_sizes: np.ndarray) -> float:
    """max/mean bucket population — 1.0 is perfectly balanced."""
    m = float(np.mean(bucket_sizes))
    return float(np.max(bucket_sizes)) / m if m > 0 else float("inf")


def compare_schedules(
    topo: OHHCTopology,
    n_total: int,
    itemsize: int = 4,
    link: LinkModel = LinkModel(),
) -> dict:
    """Analytic comm-time comparison: paper spanning-tree vs fused exchange."""
    sched = AccumulationSchedule.build(topo)
    even = [n_total // topo.total_procs] * topo.total_procs
    paper_t = model_comm_time_s(sched, even, link, itemsize)
    fused_t = ExchangeModel(link).all_to_all_time_s(
        n_total, itemsize, topo.total_procs, pods=topo.num_groups
    )
    return {
        "paper_schedule_s": paper_t,
        "fused_exchange_s": fused_t,
        "speedup": paper_t / fused_t if fused_t > 0 else float("inf"),
    }
