"""Core of the port: the paper's parallel Quick Sort on the OHHC in torch.

Modules mirror ``repro.core``: topology (OHHC graph) and schedule
(accumulation schedule) are copies; workloads holds the copied host
arithmetic of the top-k, pairs and merge operations; pytree maps over
``sort_pairs`` payloads; partition (Array Division Procedure), ohhc_sort
(simulated and host sorts; the Quick Sort counters are numpy copies),
dist_sort (the sort over ranks, ``torch.distributed``) and engine (the
autotuned dispatch layer, with the fault ladder over ``repro_torch.net``)
run on torch tensors; sample_sort holds the exchange's cost model.
"""

from repro_torch.core.topology import OHHCTopology, table_1_1, HHC_SIZE
from repro_torch.core.schedule import AccumulationSchedule, payload_bytes_per_round
from repro_torch.core.partition import (
    bucket_counts,
    bucket_ranks,
    default_capacity,
    pack_segments,
    paper_bucket_ids,
    sampled_splitters,
    scatter_to_buckets,
    splitter_bucket_ids,
    unpack_segments,
    unscatter,
)
from repro_torch.core.ohhc_sort import (
    LinkModel,
    QuickSortCounters,
    bitonic_counters,
    model_comm_time_s,
    ohhc_sort_host,
    ohhc_sort_sim,
    parallel_quicksort_counters,
    quicksort_counters,
)
from repro_torch.core.workloads import (
    WORKLOAD_OPS,
    TopKTooLarge,
    check_sorted,
    host_bucket_ids,
    host_top_k,
    merge_sorted_arrays,
    topk_cut,
)
from repro_torch.core.dist_sort import dist_sort, host_check_globally_sorted
from repro_torch.core.engine import (
    BITONIC_METHODS,
    ROW_BACKENDS,
    SEGMENT_BITONIC_MAX,
    InputStats,
    SortEngine,
    SortPlan,
    autotune_capacity,
    choose_batch_plan,
    choose_plan,
    choose_row_backend,
    estimate_batch_stats,
    estimate_stats,
)

__all__ = [
    "BITONIC_METHODS",
    "ROW_BACKENDS",
    "SEGMENT_BITONIC_MAX",
    "InputStats",
    "SortEngine",
    "SortPlan",
    "autotune_capacity",
    "choose_batch_plan",
    "choose_plan",
    "choose_row_backend",
    "estimate_batch_stats",
    "estimate_stats",
    "OHHCTopology",
    "table_1_1",
    "HHC_SIZE",
    "AccumulationSchedule",
    "payload_bytes_per_round",
    "bucket_counts",
    "bucket_ranks",
    "default_capacity",
    "pack_segments",
    "paper_bucket_ids",
    "sampled_splitters",
    "scatter_to_buckets",
    "splitter_bucket_ids",
    "unpack_segments",
    "unscatter",
    "LinkModel",
    "model_comm_time_s",
    "ohhc_sort_host",
    "ohhc_sort_sim",
    "QuickSortCounters",
    "quicksort_counters",
    "parallel_quicksort_counters",
    "bitonic_counters",
    "check_sorted",
    "host_bucket_ids",
    "WORKLOAD_OPS",
    "TopKTooLarge",
    "host_top_k",
    "merge_sorted_arrays",
    "topk_cut",
    "dist_sort",
    "host_check_globally_sorted",
]
