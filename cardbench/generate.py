"""The one traffic generator: every input a cell uses, made from ``--seed``.

A traffic file (``traffic/<mix>.json``) holds only parameters; what they
mean is here, so a new mix is a new data file.  Two kinds of input:

* sort requests: arrays of the paper's §5 distributions, a copy of
  ``repro_torch.data.distributions.make_array`` (random, sorted,
  reversed, local, dupes), cycled from a pool made in set-up;
* training batches: token ids drawn on the device from a
  ``torch.Generator``, one new batch a step, every row distinct;
* weights: one normal draw a tensor on the device, scaled by its fan-in.

Every stream takes its own generator, seeded from ``--seed`` and a tag,
so a reference can make again any one of them without the others.
"""

from __future__ import annotations

import numpy as np
import torch

def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed of its own for the stream ``tags`` of ``seed``."""
    return int(np.random.SeedSequence([seed % 2**63, *tags]).generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


# ------------------------------------------------------------------- sort
def key_space_max(dtype) -> int:
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.integer):
        return int(min(np.iinfo(dt).max, np.iinfo(np.int64).max))
    return int(np.iinfo(np.int32).max)


def make_array(dist: str, n: int, seed: int, dtype=np.int32) -> np.ndarray:
    """One request's keys, scaled to ``dtype``'s key space."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    vmax = key_space_max(dt)
    if dist == "random":
        x = rng.integers(0, vmax, n, dtype=np.int64)
    elif dist == "sorted":
        x = np.sort(rng.integers(0, vmax, n, dtype=np.int64))
    elif dist == "reversed":
        x = np.sort(rng.integers(0, vmax, n, dtype=np.int64))[::-1]
    elif dist == "dupes":
        vals = rng.integers(0, vmax, 16, dtype=np.int64)
        w = 1.0 / np.arange(1, 17)
        x = rng.choice(vals, size=n, p=w / w.sum())
    elif dist == "local":
        center = vmax // 2
        sigma = max(1.0, 1e5 * (vmax / np.iinfo(np.int32).max))
        x = rng.normal(center, sigma, n).astype(np.int64)
        k = max(n // 1000, 2)
        idx = rng.integers(0, n, k)
        x[idx] = rng.integers(0, vmax, k, dtype=np.int64)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.clip(x, 0, vmax).astype(dt)


def sort_pool(traffic: dict, seed: int) -> list[np.ndarray]:
    """The pool of distinct arrays a sort mix cycles: ``pool`` arrays of
    ``keys`` keys, the distributions of ``dists`` taken in turn."""
    dists = traffic["dists"]
    return [
        make_array(dists[i % len(dists)], traffic["keys"], sub_seed(seed, 1, i), traffic["dtype"])
        for i in range(traffic["pool"])
    ]


def kept(seed: int, every: int):
    """Whether each request, in order, is kept for the check: the first
    always, each later one with chance ``1/every``, one draw a request
    from the seed."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    yield True
    while True:
        yield bool(rng.random() < 1.0 / every)


# ------------------------------------------------------------------ train
def token_batch(traffic: dict, vocab: int, seed: int, step: int, device) -> dict:
    """Step ``step``'s batch: ``batch`` rows of ``seq_len + 1`` token ids,
    Zipf-distributed over the vocabulary with exponent ``zipf_s`` (a
    seeded permutation of the ids takes the ranks); tokens are the first
    ``seq_len``, labels the last."""
    B, S = traffic["batch"], traffic["seq_len"]
    g = torch.Generator(device).manual_seed(sub_seed(seed, 3))
    perm = torch.randperm(vocab, generator=g, device=device)
    w = torch.arange(1, vocab + 1, dtype=torch.float32, device=device).pow_(-float(traffic["zipf_s"]))
    g = torch.Generator(device).manual_seed(sub_seed(seed, 4, step))
    ranks = torch.multinomial(w, B * (S + 1), replacement=True, generator=g)
    t = perm[ranks].view(B, S + 1)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def weight(spec: tuple, seed: int, index: int, device) -> torch.Tensor:
    """Weight ``index`` of a model, from its spec ``(name, shape, std)``:
    ``std`` times one standard normal draw on the device, float32; ones
    where ``std`` is None (norm scales)."""
    _, shape, std = spec
    if std is None:
        return torch.ones(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device).manual_seed(sub_seed(seed, 5, index))
    return torch.randn(shape, generator=g, dtype=torch.float32, device=device).mul_(std)
