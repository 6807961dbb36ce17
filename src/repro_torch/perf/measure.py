"""Timing discipline for every benchmark and perf gate (DESIGN.md §9).

The port's copy of ``repro.perf.measure``.

One measurement contract, enforced everywhere a wall-clock number can end
up in a committed baseline:

* **warmup first** — a kernel's build (nvcc at its first launch), allocator
  growth, and cache fill are paid before the timed region, never inside it;
* **sync before stopping the clock** — a CUDA launch returns before the
  card finishes, so every device a result's tensors lie on is
  synchronised before the clock stops, or the number measures enqueue
  cost, not execution;
* **median-of-k with dispersion** — the reported value is the median of
  ``repeats`` timed calls and the IQR rides along, so a baseline diff can
  tell a real regression from a noisy sample.

``measure`` times one callable; ``measure_interleaved`` times a *group* of
configs round-robin (config A, B, C, A, B, C, …) so slow drift — allocator
warm-up, frequency scaling, a background process — biases every config
equally instead of whichever was timed first.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

DEFAULT_WARMUP = 1
DEFAULT_REPEATS = 5


def median_iqr(samples: Sequence[float]) -> tuple[float, float]:
    """(median, interquartile range) of a sample set.

    The IQR is the dispersion record every baseline carries: non-negative,
    robust to a single outlier sample, zero for a single repeat.
    """
    a = np.asarray(list(samples), dtype=np.float64)
    if a.size == 0:
        raise ValueError("median_iqr needs at least one sample")
    q25, q75 = np.percentile(a, (25.0, 75.0))
    return float(np.median(a)), float(max(q75 - q25, 0.0))


def _cuda_devices(result, found: set) -> None:
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            found.add(result.device)
    elif isinstance(result, (list, tuple)):
        for r in result:
            _cuda_devices(r, found)
    elif isinstance(result, Mapping):
        for r in result.values():
            _cuda_devices(r, found)


def default_sync(result) -> None:
    """Drain the card's work behind ``result`` (tensors / pytrees).

    numpy results, CPU tensors, Python numbers and None are already
    synchronous; lists, tuples and dicts are walked, and every CUDA device
    a tensor leaf lies on is synchronised once, so multi-output calls wait
    for every leaf.
    """
    found: set = set()
    _cuda_devices(result, found)
    for dev in found:
        torch.cuda.synchronize(dev)


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Median-of-k timing with its dispersion and provenance."""

    median_s: float
    iqr_s: float
    min_s: float
    max_s: float
    samples_s: tuple
    warmup: int
    repeats: int

    def as_dict(self) -> dict:
        return {
            "median_s": self.median_s,
            "iqr_s": self.iqr_s,
            "min_s": self.min_s,
            "max_s": self.max_s,
            "warmup": self.warmup,
            "repeats": self.repeats,
        }


def _timed_call(fn: Callable[[], object], sync) -> float:
    t0 = time.perf_counter()
    out = fn()
    if sync is not None:
        sync(out)
    return time.perf_counter() - t0


def measure(
    fn: Callable[[], object],
    *,
    warmup: int = DEFAULT_WARMUP,
    repeats: int = DEFAULT_REPEATS,
    sync=default_sync,
) -> Measurement:
    """Time a zero-arg callable under the measurement contract."""
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    for _ in range(max(warmup, 0)):
        out = fn()
        if sync is not None:
            sync(out)
    samples = [_timed_call(fn, sync) for _ in range(repeats)]
    med, iqr = median_iqr(samples)
    return Measurement(
        median_s=med,
        iqr_s=iqr,
        min_s=float(min(samples)),
        max_s=float(max(samples)),
        samples_s=tuple(samples),
        warmup=max(warmup, 0),
        repeats=repeats,
    )


def measure_interleaved(
    fns: "Mapping[str, Callable[[], object]]",
    *,
    warmup: int = DEFAULT_WARMUP,
    repeats: int = DEFAULT_REPEATS,
    sync=default_sync,
) -> "dict[str, Measurement]":
    """Time a group of configs round-robin (drift hits all equally)."""
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    names = list(fns)
    for _ in range(max(warmup, 0)):
        for name in names:
            out = fns[name]()
            if sync is not None:
                sync(out)
    samples: dict[str, list[float]] = {name: [] for name in names}
    for _ in range(repeats):
        for name in names:
            samples[name].append(_timed_call(fns[name], sync))
    out_d = {}
    for name in names:
        med, iqr = median_iqr(samples[name])
        out_d[name] = Measurement(
            median_s=med,
            iqr_s=iqr,
            min_s=float(min(samples[name])),
            max_s=float(max(samples[name])),
            samples_s=tuple(samples[name]),
            warmup=max(warmup, 0),
            repeats=repeats,
        )
    return out_d
