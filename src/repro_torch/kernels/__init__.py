"""Hand-written CUDA kernels of the port, each beside its plain torch version.

* ``bitonic``          — bitonic tile sort (``sort_tile``), in-place
                         two-tile merge (``merge_tile_pairs``/``merge_tiles``)
                         and the pair sorts (``sort_pairs_tile_tagged``,
                         ``sort_pairs_tile``)
* ``batched``          — fused segmented row sort (``batched_row_sort``)
                         and its pair twin (``batched_row_sort_pairs``)
* ``partition_kernel`` — bucket histogram + stable ranks
                         (``bucket_count_rank``)
* ``ops``              — the compositions the core calls
* ``ref``              — plain-torch oracles (library sorts)

Sources are in ``csrc/`` and are built by ``_build`` on first use.  Every
kernel wrapper carries a ``launches`` count of the kernels it launched,
kept under one lock (``_launches``) so that threads lose no count.
"""

from repro_torch.kernels import _launches, batched, bitonic, ops, partition_kernel, ref

# Name → wrapper whose ``launches`` counts that kernel's launches.
KERNELS = {
    "bucket_count_rank": partition_kernel.bucket_count_rank,
    "sort_tile": bitonic.sort_tile,
    "merge_tiles": bitonic.merge_tile_pairs,
    "batched_row_sort": batched.batched_row_sort,
    "sort_pairs_tile_tagged": bitonic.sort_pairs_tile_tagged,
    "batched_row_sort_pairs": batched.batched_row_sort_pairs,
    "sort_pairs_tile": bitonic.sort_pairs_tile,
}


def reset_launches() -> None:
    with _launches.LOCK:
        for fn in KERNELS.values():
            fn.launches = 0


def launch_counts() -> dict[str, int]:
    with _launches.LOCK:
        return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "batched",
    "bitonic",
    "launch_counts",
    "ops",
    "partition_kernel",
    "ref",
    "reset_launches",
]
