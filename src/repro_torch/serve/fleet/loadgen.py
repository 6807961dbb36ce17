"""Shared load-generation for the fleet: request mixes and drive loops
(DESIGN.md §10).

One implementation used by ``chip_smoke.py`` (phase 7, the fleet on the
card) and ``tests/test_torch_fleet.py`` (chaos correctness) — so the
"same workload mix" clause of the fleet acceptance criteria is literal:
every comparison draws from :func:`request_mix` with the same seed.

The drive loops only require a ``submit(arr) -> Future`` callable, so a
single :class:`~repro_torch.serve.sortd.Sortd` and a
:class:`~repro_torch.serve.fleet.SortdFleet` are driven through the identical
code path (closed-loop: N synchronous clients submit → wait → repeat —
throughput is the output; open-loop: fixed arrival schedule — latency is
the output).

The port's copy of ``repro.serve.fleet.loadgen``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["request_mix", "drive_closed_loop", "drive_open_loop"]


def request_mix(
    n_requests: int,
    *,
    dtype: str = "int32",
    seed: int = 11,
    max_bucket: int = 1 << 12,
    oversize_frac: float = 0.02,
) -> "list[np.ndarray]":
    """Serving-shaped request stream: concentrated small buckets + a thin
    oversize tail.

    10% of requests land in the 64–512 bucket, ~58% in 512–2048, 30% in
    2048–4096, and ``oversize_frac`` beyond ``max_bucket`` (exercising the
    per-array direct path — the head-of-line blocking case a fleet
    isolates).  Deterministic per seed.
    """
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_requests):
        r = rng.random()
        if r < oversize_frac:
            lo, hi = max_bucket + 1, max_bucket * 2
        elif r < oversize_frac + 0.10:
            lo, hi = 64, 512
        elif r < oversize_frac + 0.68:
            lo, hi = 512, 2048
        else:
            lo, hi = 2048, 4096
        n = int(rng.integers(lo, hi))
        out.append(rng.integers(0, 1 << 30, n).astype(dtype))
    return out


def drive_closed_loop(
    submit,
    reqs: "list[np.ndarray]",
    *,
    clients: int = 8,
    timeout: float = 120.0,
) -> "tuple[float, list]":
    """``clients`` synchronous clients round-robin the request list.

    Returns ``(wall_s, outs)`` with ``outs[i]`` the sorted result of
    ``reqs[i]``; raises if any request failed or timed out — a lost answer
    is a harness failure, never a silent hole in the results.
    """
    outs: list = [None] * len(reqs)
    errors: list = []

    def client(cid: int) -> None:
        for i in range(cid, len(reqs), clients):
            try:
                outs[i] = submit(reqs[i]).result(timeout=timeout)
            except Exception as e:  # noqa: BLE001 — reported, not swallowed
                errors.append((i, repr(e)))

    threads = [
        threading.Thread(target=client, args=(c,), name=f"loadgen-{c}")
        for c in range(clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(
            f"{len(errors)}/{len(reqs)} requests failed: {errors[:3]}"
        )
    return wall, outs


def drive_open_loop(
    submit,
    reqs: "list[np.ndarray]",
    *,
    rate: float = 300.0,
    timeout: float = 120.0,
) -> "tuple[float, list]":
    """Fixed arrival schedule at ``rate`` req/s regardless of completion
    (arrival is the input, latency is the output).  Same return/raise
    contract as :func:`drive_closed_loop`."""
    period = 1.0 / rate
    futs = []
    t0 = time.perf_counter()
    for i, x in enumerate(reqs):
        delay = (t0 + i * period) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futs.append(submit(x))
    outs = [f.result(timeout=timeout) for f in futs]
    wall = time.perf_counter() - t0
    return wall, outs
