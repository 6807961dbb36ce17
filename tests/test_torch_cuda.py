"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA
device.  The file imports neither jax nor the JAX package, so it also runs
on a machine with the card and no jax:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import batched, bitonic, partition_kernel


def _keys(rng, shape, dtype):
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, shape, dtype=np.int64, endpoint=True).astype(dt)
    return rng.standard_normal(shape).astype(dt)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _card_keys(rng, shape, dtype, device):
    return torch.from_numpy(_keys(rng, shape, dtype)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (np.int8, np.int16, np.int32, np.int64, np.float32), ids=lambda d: np.dtype(d).name)
def test_cuda_sort_and_merge_match_plain(dtype, cuda_device, rng):
    x = _card_keys(rng, (5, 1 << 15), dtype, cuda_device)
    got = bitonic.sort_tile(x)
    assert torch.equal(got, bitonic.sort_tile_plain(x))
    tiles = got.view(5, 4, 1 << 13).contiguous()
    want = tiles.clone()
    bitonic.merge_tile_pairs(tiles, 0)
    bitonic.merge_tile_pairs_plain(want, 0)
    assert torch.equal(tiles, want)


@pytest.mark.cuda
@pytest.mark.parametrize("method", batched.METHODS)
def test_cuda_batched_row_sort_matches_plain(method, cuda_device, rng):
    for dtype in (np.int8, np.int16, np.int32, np.int64, np.float32):
        x = _card_keys(rng, (16, 8192 if np.dtype(dtype).itemsize < 8 else 4096), dtype, cuda_device)
        lens = torch.from_numpy(rng.integers(0, x.shape[1] + 1, 16).astype(np.int32)).to(cuda_device)
        got = batched.batched_row_sort(x, lens, method=method)
        assert torch.equal(got, batched.batched_row_sort_plain(x, lens, method=method))


@pytest.mark.cuda
@pytest.mark.parametrize("num_buckets", (1, 37, 2305))
def test_cuda_bucket_count_rank_matches_plain(num_buckets, cuda_device, rng):
    ids = torch.from_numpy(rng.integers(0, num_buckets, 100_003).astype(np.int32)).to(cuda_device)
    got = partition_kernel.bucket_count_rank(ids, num_buckets)
    want = partition_kernel.bucket_count_rank_plain(ids, num_buckets)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (np.int8, np.int64, np.uint32, np.float32), ids=lambda d: np.dtype(d).name)
def test_cuda_engine_sort_and_segments_match_np_sort(dtype, cuda_device, rng):
    from repro_torch.core import SortEngine

    eng = SortEngine()
    # uniform keys: a skewed input this large would plan onto the host path
    x = _keys(rng, 200_000, dtype) if dtype != np.float32 else rng.uniform(-1e6, 1e6, 200_000).astype(dtype)
    assert np.array_equal(eng.sort(x), np.sort(x))
    assert eng.last_report["plan"].path == "sim"
    segs = [_keys(rng, n, dtype) for n in (0, 1, 129, 4000, 8192)]
    out = eng.sort_segments(np.concatenate(segs), [s.size for s in segs])
    for o, s in zip(out, segs):
        assert np.array_equal(o, np.sort(s))
