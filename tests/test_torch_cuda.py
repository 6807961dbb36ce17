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


def _bits(t):
    # keys compared through their integer bit view: torch.equal counts
    # -0.0 equal to +0.0
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (np.int8, np.int16, np.int32, np.int64, np.float32), ids=lambda d: np.dtype(d).name)
def test_cuda_sort_and_merge_match_plain(dtype, cuda_device, rng):
    x = _card_keys(rng, (5, 1 << 15), dtype, cuda_device)
    got = bitonic.sort_tile(x)
    assert torch.equal(_bits(got), _bits(bitonic.sort_tile_plain(x)))
    tiles = got.view(5, 4, 1 << 13).contiguous()
    want = tiles.clone()
    bitonic.merge_tile_pairs(tiles, 0)
    bitonic.merge_tile_pairs_plain(want, 0)
    assert torch.equal(_bits(tiles), _bits(want))


# Row lengths at every boundary of the tile sort's tiers (csrc/bitonic.cu:
# 16 keys a thread, 32 KiB chunks): 128 keys (a partial warp), one warp's
# 512, one chunk of int64 (2^12), int32 (2^13) and int8/int16 (2^14), two
# and four chunks (the first device windows), 2^17 and 2^18 (where a
# stage first takes two device windows for int64 and int32), 2^19 (for
# int8/int16) and 2^20.
TILE_SIZES = (128, 512, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20)


def _tile_keys(rng, shape, dtype, case, device):
    if case == "heavy_ties":
        return torch.from_numpy(rng.integers(0, 16, shape).astype(dtype)).to(device)
    x = _keys(rng, shape, dtype)
    if case == "signed_zeros":  # about half the keys -0.0 or +0.0
        zero = rng.random(shape) < 0.5
        x[zero] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(0.0), np.float32(-0.0))
    return torch.from_numpy(x).to(device)


TILE_CASES = [
    (dtype, case)
    for dtype in (np.int8, np.int16, np.int32, np.int64, np.float32)
    for case in ("spread", "heavy_ties") + (("signed_zeros",) if dtype == np.float32 else ())
]


@pytest.mark.cuda
@pytest.mark.parametrize("n", TILE_SIZES)
@pytest.mark.parametrize("dtype,case", TILE_CASES, ids=[f"{np.dtype(d).name}-{c}" for d, c in TILE_CASES])
def test_cuda_sort_tile_tiers_match_plain(dtype, case, n, cuda_device, rng):
    # K2 at every tier boundary, bit for bit: heavy ties and signed zeros
    # show a wrong schedule in the bytes even where the keys still sort
    x = _tile_keys(rng, (3 if n <= 1 << 16 else 1, n), dtype, case, cuda_device)
    got = bitonic.sort_tile(x)
    assert torch.equal(_bits(got), _bits(bitonic.sort_tile_plain(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((36, 1 << 18), (2304, 4096), (1, 1 << 22)), ids=str)
@pytest.mark.parametrize("dtype", (np.int32, np.float32), ids=lambda d: np.dtype(d).name)
def test_cuda_sort_tile_main_path_shapes_match_plain(dtype, shape, cuda_device, rng):
    # SortEngine.sort's tiles at 2^22 keys, long-row sort_segments' rows,
    # and a row of 2^22 (its last stage takes three device windows)
    x = _tile_keys(rng, shape, dtype, "signed_zeros" if dtype == np.float32 else "spread", cuda_device)
    got = bitonic.sort_tile(x)
    assert torch.equal(_bits(got), _bits(bitonic.sort_tile_plain(x)))
    assert torch.equal(got, torch.sort(x, dim=-1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("method", batched.METHODS)
def test_cuda_batched_row_sort_matches_plain(method, cuda_device, rng):
    for dtype in (np.int8, np.int16, np.int32, np.int64, np.float32):
        x = _card_keys(rng, (16, 8192 if np.dtype(dtype).itemsize < 8 else 4096), dtype, cuda_device)
        lens = torch.from_numpy(rng.integers(0, x.shape[1] + 1, 16).astype(np.int32)).to(cuda_device)
        got = batched.batched_row_sort(x, lens, method=method)
        assert torch.equal(got, batched.batched_row_sort_plain(x, lens, method=method))


# Row lengths at every boundary of the row sort's tiers (csrc/batched.cu on
# key_tiers.cuh): 128 keys (a partial warp), one warp's 512, one chunk of
# int64 (2^12), int32 (2^13) and int8/int16 (2^14), then rows past the
# chunk (device windows) up to 64 KiB a row.
ROW_SIZES = (128, 512, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16)
ROW_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.float32)


def _row_keys(rng, rows, n, dtype, device):
    """16-value ties, some keys equal to the sentinel, signed zeros for
    float32; lengths at a home run's edges, the row's, past both ends and
    random; garbage in the pads."""
    raw = rng.integers(0, 16, (rows, n))
    if dtype == np.float32:
        x = (raw - 8).astype(np.float32)
        x[raw == 15] = np.inf
        x[(raw == 8) & (rng.random((rows, n)) < 0.5)] = -0.0
    else:
        x = raw.astype(dtype)
        x[raw == 15] = np.iinfo(dtype).max
    lens = np.concatenate([[0, 1, 15, 16, 17, n - 1, n, -3, n + 5], rng.integers(0, n + 1, rows - 9)]).astype(np.int32)
    junk = _keys(rng, (rows, n), dtype)
    x = np.where(np.arange(n)[None, :] >= lens[:, None], junk, x)
    return torch.from_numpy(x).to(device), torch.from_numpy(lens).to(device)


# every row the wrapper takes: up to MAX_ROW_BYTES a row
ROW_CASES = [(d, n) for d in ROW_DTYPES for n in ROW_SIZES if n * np.dtype(d).itemsize <= batched.MAX_ROW_BYTES]


@pytest.mark.cuda
@pytest.mark.parametrize("method", batched.METHODS)
@pytest.mark.parametrize("dtype,n", ROW_CASES, ids=[f"{np.dtype(d).name}-{n}" for d, n in ROW_CASES])
def test_cuda_batched_row_sort_tiers_match_plain(dtype, n, method, cuda_device, rng):
    # K4 bit for bit at every tier boundary, every key dtype, both methods
    x, lens = _row_keys(rng, 16, n, dtype, cuda_device)
    got = batched.batched_row_sort(x, lens, method=method)
    assert torch.equal(_bits(got), _bits(batched.batched_row_sort_plain(x, lens, method=method)))


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


def _card_payload(rng, shape, dtype, device):
    bits = bitonic._BITS[torch.empty((), dtype=dtype).element_size()]
    return torch.from_numpy(rng.integers(-(2**62), 2**62, shape)).to(bits).view(dtype).to(device)


# Row lengths at every boundary of the pair sort's tiers (csrc/bitonic.cu):
# within one warp, one warp, one block's 2,048-pair chunk, two and four
# chunks (the first lengths with device-memory windows), longer rows, and
# full width.
PAIR_SIZES = (128, 256, 2048, 4096, 8192, 1 << 15, 1 << 16, 1 << 19)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", (False, True), ids=("spread", "heavy_ties"))
@pytest.mark.parametrize("n", PAIR_SIZES)
@pytest.mark.parametrize("dtype", (np.int8, np.int16, np.int32, np.int64, np.float32), ids=lambda d: np.dtype(d).name)
def test_cuda_pair_sorts_match_plain(dtype, n, ties, cuda_device, rng):
    # K5 and K7, every payload width; heavy ties draw keys from 16 values,
    # where a wrong schedule shows as a wrong payload order
    rows = 1 if n == 1 << 19 else 3
    for vdtype in (torch.bool, torch.bfloat16, torch.float32, torch.float64):
        if ties:
            k = torch.from_numpy(rng.integers(0, 16, (rows, n)).astype(dtype)).to(cuda_device)
        else:
            k = _card_keys(rng, (rows, n), dtype, cuda_device)
        k[:, ::9] = torch.iinfo(k.dtype).max if not k.dtype.is_floating_point else float("inf")
        v = _card_payload(rng, (rows, n), vdtype, cuda_device)
        t = torch.rand(rows, n, device=cuda_device) < 0.3
        bits = bitonic._BITS[v.element_size()]
        got = bitonic.sort_pairs_tile_tagged(k, t, v)
        want = bitonic.sort_pairs_tile_tagged_plain(k, t, v)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1].view(bits), want[1].view(bits))
        got = bitonic.sort_pairs_tile(k, v)
        want = bitonic.sort_pairs_tile_plain(k, v)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1].view(bits), want[1].view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("length", (256, 8192, 1 << 15))
def test_cuda_batched_row_sort_pairs_matches_plain(length, cuda_device, rng):
    # 2^15 int32/int32 pairs pass one block's shared memory: the fill in
    # torch, then the multi-pass pair kernel
    for dtype in (np.int32, np.int64, np.float32):
        k = _card_keys(rng, (6, length), dtype, cuda_device)
        v = _card_payload(rng, (6, length), torch.int32, cuda_device)
        lens = torch.from_numpy(rng.integers(0, length + 1, 6).astype(np.int32)).to(cuda_device)
        got = batched.batched_row_sort_pairs(k, v, lens)
        want = batched.batched_row_sort_pairs_plain(k, v, lens)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# Pair row lengths at every boundary of the pair row sort (csrc/batched.cu
# pair_chunk_rows): under one warp's 256 pairs, one warp, one thread's runs
# doubling up to a row that fills one block's shared memory, and a row past
# it (the fill in torch, then the pair sort's launches).
ROW_PAIR_SIZES = (128, 256, 512, 2048, 8192, 1 << 14, 1 << 15, 1 << 16)


@pytest.mark.cuda
@pytest.mark.parametrize("n", ROW_PAIR_SIZES)
@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=lambda d: np.dtype(d).name)
def test_cuda_batched_row_sort_pairs_tiers_match_plain(dtype, n, cuda_device, rng):
    # K6 bit for bit, every key dtype and payload width: ties broken by the
    # payload order show a wrong schedule even where the keys sort
    for vdtype in (torch.bool, torch.bfloat16, torch.int32, torch.float64):
        k, lens = _row_keys(rng, 12, n, dtype, cuda_device)
        v = _card_payload(rng, (12, n), vdtype, cuda_device)
        bits = bitonic._BITS[v.element_size()]
        got = batched.batched_row_sort_pairs(k, v, lens)
        want = batched.batched_row_sort_pairs_plain(k, v, lens)
        assert torch.equal(_bits(got[0]), _bits(want[0])) and torch.equal(got[1].view(bits), want[1].view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (np.int32, np.int64, np.uint32, np.float32), ids=lambda d: np.dtype(d).name)
def test_cuda_engine_pairs_and_workloads_match_numpy(dtype, cuda_device, rng):
    from repro_torch.core import SortEngine

    eng = SortEngine()
    x = _keys(rng, 100_000, dtype) if dtype != np.float32 else rng.uniform(-1e6, 1e6, 100_000).astype(dtype)
    ks, perm = eng.argsort_keys(x)
    assert eng.last_report["plan"].path == "sim"
    assert np.array_equal(ks, np.sort(x)) and np.array_equal(x[perm], ks)
    assert np.array_equal(np.sort(perm), np.arange(x.size))
    ks, vs = eng.sort_pairs(x, np.arange(x.size, dtype=np.int32))
    assert ks.device.type == "cuda" and np.array_equal(x[vs.cpu().numpy()], np.sort(x))
    assert np.array_equal(eng.top_k(x, 60_000), np.sort(x)[:60_000])
    assert eng.last_report["plan"].path == "sim"
    buf = np.sort(x[:50_000])
    assert np.array_equal(eng.merge_sorted(buf, x[50_000:]), np.sort(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (np.int8, np.int16, np.int32, np.int64, np.float32), ids=lambda d: np.dtype(d).name)
def test_cuda_sort_tile_unaligned_rows_match_plain(dtype, cuda_device, rng):
    # a contiguous batch one key past a 16-byte boundary: the kernel moves
    # its home runs key by key instead of in 16-byte words
    n = 1 << 15
    buf = _card_keys(rng, (2 * n + 1,), dtype, cuda_device)
    x = buf[1:].view(2, n)
    assert x.data_ptr() % 16
    got = bitonic.sort_tile(x)
    assert torch.equal(_bits(got), _bits(bitonic.sort_tile_plain(x)))


# Segment lengths at every boundary of the merge's tiers (csrc/bitonic.cu,
# merge_pairs): 2^8 .. 2^21 keys a merged pair, so segments within one
# chunk (read flipped by the chunk launch) for every key width, one past
# it (the flip window takes one distance), and longer ones with device
# windows; each with 2-5 tiles a row and both half-passes.
MERGE_LOG_SEGS = range(8, 22)


def _merge_tiles_buf(rng, rows, tiles, m, dtype, case, device):
    x = _tile_keys(rng, (rows, tiles, m), dtype, case, device)
    return torch.sort(x, dim=-1).values.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("log_seg", MERGE_LOG_SEGS)
@pytest.mark.parametrize("dtype,case", TILE_CASES, ids=[f"{np.dtype(d).name}-{c}" for d, c in TILE_CASES])
def test_cuda_merge_tile_pairs_tiers_match_plain(dtype, case, log_seg, cuda_device, rng):
    # K3 bit for bit against the plain merge network, heavy ties and signed
    # zeros included, and against torch.sort of each merged pair
    m = 1 << (log_seg - 1)
    configs = [(t, f) for t in (2, 3, 4, 5) for f in (0, 1)] if log_seg <= 16 else [(2, 0), (3, 1)]
    for tiles, first in configs:
        rows = 2 if log_seg <= 16 else 1
        buf = _merge_tiles_buf(rng, rows, tiles, m, dtype, case, cuda_device)
        want = bitonic.merge_tile_pairs_plain(buf.clone(), first)
        got = bitonic.merge_tile_pairs(buf.clone(), first)
        assert torch.equal(_bits(got), _bits(want)), (tiles, first)
        k = (tiles - first) // 2
        pairs = buf[:, first : first + 2 * k].reshape(rows, k, 2 * m)
        assert torch.equal(got[:, first : first + 2 * k].reshape(rows, k, 2 * m), torch.sort(pairs, dim=-1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (np.int32, np.float32), ids=lambda d: np.dtype(d).name)
def test_cuda_merge_tile_pairs_main_path_shape_matches_plain(dtype, cuda_device, rng):
    # SortEngine.sort's half-pass at 15,728,640 keys: 36 rows of two 2^19 tiles
    buf = _merge_tiles_buf(rng, 36, 2, 1 << 19, dtype, "signed_zeros" if dtype == np.float32 else "spread", cuda_device)
    got = bitonic.merge_tile_pairs(buf.clone(), 0)
    assert torch.equal(_bits(got), _bits(bitonic.merge_tile_pairs_plain(buf.clone(), 0)))
    lo, hi = bitonic.merge_tiles(buf[:, 0], buf[:, 1])
    assert torch.equal(lo, got[:, 0]) and torch.equal(hi, got[:, 1])


# K1 at the bucket counts the path hands it (1, 2, P+1 at d_h = 1 and 2,
# long-row sort_segments' 64 x 37, the limit) and at every boundary of its
# tiles, whose length the library gives for each B.
BCR_BUCKETS = (1, 2, 37, 145, 2368, 4096)
BCR_SIZES = ("1", "tile-1", "tile", "tile+1", "2^22", "2^24")


def _bcr_n(size, num_buckets):
    from repro_torch.kernels import _build

    tile = _build.load("partition").rt_bcr_tile(num_buckets)
    return {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1, "2^22": 1 << 22, "2^24": 1 << 24}[size]


def _same_counts_ranks(ids, nb):
    got = partition_kernel.bucket_count_rank(ids, nb)
    want = partition_kernel.bucket_count_rank_plain(ids, nb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    valid = ids[(ids >= 0) & (ids < nb)]
    assert torch.equal(got[0], torch.bincount(valid, minlength=nb).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("size", BCR_SIZES)
@pytest.mark.parametrize("num_buckets", BCR_BUCKETS)
def test_cuda_bucket_count_rank_sizes_match_plain(num_buckets, size, cuda_device, rng):
    n = _bcr_n(size, num_buckets)
    ids = torch.from_numpy(rng.integers(0, num_buckets, n).astype(np.int32)).to(cuda_device)
    _same_counts_ranks(ids, num_buckets)


@pytest.mark.cuda
@pytest.mark.parametrize("num_buckets", (1, 37, 4096))
@pytest.mark.parametrize("size", ("tile+1", "2^22"))
def test_cuda_bucket_count_rank_one_bucket_and_out_of_range(size, num_buckets, cuda_device, rng):
    # every id in one bucket (the most contention), then a third of the ids
    # out of range on both sides: not counted, rank 0, nothing written past
    n = _bcr_n(size, num_buckets)
    ids = torch.full((n,), num_buckets - 1, dtype=torch.int32, device=cuda_device)
    _same_counts_ranks(ids, num_buckets)
    ids = torch.from_numpy(rng.integers(0, num_buckets, n).astype(np.int32)).to(cuda_device)
    ids[::6] = -3
    ids[1::6] = num_buckets
    ids[2::6] = -(2**31)
    _same_counts_ranks(ids, num_buckets)


@pytest.mark.cuda
def test_cuda_bucket_count_rank_unaligned_ids_match_plain(cuda_device, rng):
    # ids one int past a 16-byte boundary: the per-thread kernel loads and
    # stores its runs id by id instead of in 16-byte words
    buf = torch.from_numpy(rng.integers(0, 37, (1 << 20) + 1).astype(np.int32)).to(cuda_device)
    ids = buf[1:]
    assert ids.data_ptr() % 16
    _same_counts_ranks(ids, 37)


@pytest.mark.cuda
def test_cuda_bucket_count_rank_past_one_launch_is_one_stable_pass(cuda_device):
    # 2^30 + 2^20 ids, past the kernel's 2^30 - 1 a launch: two launches with
    # the counts carried.  The oracle: torch.bincount, and each id's rank
    # read off a stable torch.sort (out-of-range ids in a bucket of their
    # own, then rank 0).  About 30 GB of the card at the peak.
    n, nb = (1 << 30) + (1 << 20), 37
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.randint(0, nb, (n,), dtype=torch.int32, device=cuda_device, generator=gen)
    ids[-(1 << 19) :: 7] = -1
    ids[-(1 << 18) :: 5] = nb
    before = partition_kernel.bucket_count_rank.launches
    counts, ranks = partition_kernel.bucket_count_rank(ids, nb)
    assert partition_kernel.bucket_count_rank.launches == before + 2
    valid = (ids >= 0) & (ids < nb)
    keyed = torch.where(valid, ids, nb)
    assert torch.equal(counts, torch.bincount(keyed, minlength=nb + 1)[:nb].to(torch.int32))
    del ids
    starts = torch.cumsum(torch.bincount(keyed, minlength=nb + 1), 0) - torch.bincount(keyed, minlength=nb + 1)
    order_vals, order = torch.sort(keyed, stable=True)
    del keyed
    want = torch.empty(n, dtype=torch.int32, device=cuda_device)
    step = 1 << 27
    for a in range(0, n, step):
        pos = torch.arange(a, min(a + step, n), device=cuda_device)
        want[order[a : a + step]] = (pos - starts[order_vals[a : a + step].long()]).to(torch.int32)
    del order, order_vals
    want[~valid] = 0
    assert torch.equal(ranks, want)


@pytest.mark.cuda
def test_cuda_sortd_serves_exactly_through_the_kernels(cuda_device, monkeypatch):
    """``Sortd`` over ``SortEngine()`` on the card: short rows through the
    row kernel K4, a flush of rows past 8,192 keys through K1 and K2, and
    an impossible fault scenario through the host with no launch."""
    # the suite pins the row backend to the library sort (tests/conftest.py);
    # unpinned, the engine races only the row kernel's two stages
    monkeypatch.delenv("REPRO_ROW_BACKEND", raising=False)
    from repro_torch.core import SortEngine
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.net.faults import FaultScenario
    from repro_torch.serve import Sortd, SortdConfig

    rng = np.random.default_rng(71)
    short = [rng.integers(0, 1 << 30, int(n)).astype(np.int32) for n in rng.integers(64, 4096, 24)]
    long = [rng.integers(0, 1 << 30, int(n)).astype(np.int32) for n in rng.integers(8193, 16384, 4)]
    eng = SortEngine()
    reset_launches()
    with Sortd(eng, SortdConfig(max_batch=8, max_wait_s=0.005)) as sd:
        futs = [sd.submit(x) for x in short + long]
        for x, f in zip(short + long, futs):
            assert np.array_equal(f.result(timeout=120), np.sort(x))
        counts = launch_counts()
        assert counts["batched_row_sort"] > 0
        assert counts["bucket_count_rank"] > 0 and counts["sort_tile"] > 0
        sd.set_fault_scenario(FaultScenario.worker_down(1))
        reset_launches()
        for x in short[:8] + long[:1]:
            assert np.array_equal(sd.sort(x), np.sort(x))
        assert sum(launch_counts().values()) == 0


@pytest.mark.cuda
def test_cuda_verify_tier1_grid_has_no_drift(cuda_device):
    """The tier-1 conformance cells (sort, segment and op) on the card:
    every cell exact, the paths agreeing, and no drift against the
    committed port baseline recorded on the CPU."""
    from pathlib import Path

    from repro_torch.verify import baseline, differential, grid

    engines = differential.EngineCache()
    results = differential.run_grid(grid.tier1_grid(), engines=engines)
    results += differential.run_segment_grid(grid.segment_tier1_grid(), engines=engines)
    results += differential.run_op_grid(grid.op_tier1_grid(), engines=engines)
    assert all(e.device.type == "cuda" for e in engines._engines.values())
    fails = [(r.scenario_id, r.detail) for r in results if r.status != "pass"]
    assert not fails, fails
    assert differential.cross_check(results) == []
    committed = baseline.load_baseline(Path(__file__).parent / "baselines" / "verify_smoke_torch.json")
    drift = baseline.diff_baselines(
        baseline.build_baseline(results, grid="tier1"), committed, ignore_missing_in_current=True
    )
    assert drift.clean, drift.summary()


SERVED = (
    "mixtral-8x22b", "deepseek-v2-lite-16b", "minitron-4b", "qwen1.5-32b", "qwen1.5-110b", "gemma3-4b",
    "mamba2-370m", "zamba2-2.7b", "whisper-tiny", "qwen2-vl-7b",
)


def _family_batch(cfg, toks: torch.Tensor) -> dict:
    """Tokens and the family's extra inputs, from a seed: encoder frames
    (encdec), vision embeddings with a (3, B, S) grid (vlm)."""
    g = np.random.default_rng(4)
    B, S = toks.shape
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        frames = g.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        batch["enc_frames"] = torch.from_numpy(frames)
    if cfg.family == "vlm":
        V = cfg.vision_tokens
        batch["vision_embeds"] = torch.from_numpy(g.standard_normal((B, V, cfg.d_model)).astype(np.float32))
        thw = np.broadcast_to(np.arange(S), (3, B, S)).copy()
        thw[0, :, :V], thw[1, :, :V], thw[2, :, :V] = 0, np.arange(V) // 4, np.arange(V) % 4
        batch["positions_thw"] = torch.from_numpy(thw.astype(np.int32))
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SERVED)
def test_cuda_smoke_model_serves_as_on_the_cpu(arch, cuda_device):
    """The smoke config in float32 on the card and on the CPU, on the same
    seeded weights: forward logits within 1e-4 (float32 sums in another
    order; no TF32) and the same greedy tokens from ``ServeEngine``."""
    from repro_torch.configs import registry
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.models.common import tree_map
    from repro_torch.serve import ServeEngine

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = registry.get_config(arch, smoke=True).replace(dtype=torch.float32)
    api = registry.get_model_api(cfg)
    cpu = api.init(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    batch = _family_batch(cfg, torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))))
    want, _ = api.forward(cpu, batch, cfg)
    got, _ = api.forward(card, tree_map(lambda t: t.to(cuda_device), batch), cfg)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    reqs = synthetic_requests(4, cfg.vocab_size, 6)
    want = ServeEngine(cfg, cpu, api, max_len=64, device="cpu").generate(reqs)
    reset_launches()
    got = ServeEngine(cfg, card, api, max_len=64).generate(reqs)
    counts = launch_counts()
    assert got == want
    assert counts["sort_pairs_tile_tagged"] == 1
    assert counts["bucket_count_rank"] == (cfg.num_layers * 6 if cfg.is_moe else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32), ids=("bf16", "f32"))
def test_cuda_moe_dispatch_on_k1_equals_its_plain_version(dtype, cuda_device, monkeypatch):
    """DeepSeek's fan-out (64 experts, top-6, 2 shared) at narrow widths:
    the ``sorted`` dispatch with K1, with K1's plain version and the
    ``argsort`` dispatch give equal outputs bit for bit, one launch of K1."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import launch_counts, ops, reset_launches
    from repro_torch.models import moe
    from repro_torch.models.common import NO_SHARD

    cfg = registry.get_config("deepseek-v2-lite-16b", smoke=True).replace(dtype=dtype)
    m = dataclasses.replace(cfg.moe, num_experts=64, num_experts_per_tok=6, expert_d_ff=32, capacity_factor=1.25)
    cfg = cfg.replace(moe=m)
    p = moe.init_moe(torch.Generator(device=cuda_device).manual_seed(4), cfg)
    x = torch.randn((16, 47, cfg.d_model), generator=torch.Generator(device=cuda_device).manual_seed(5),
                    device=cuda_device).to(dtype)
    reset_launches()
    y_k1, _ = moe.apply_moe(p, x, cfg, NO_SHARD)
    assert launch_counts()["bucket_count_rank"] == 1
    y_argsort, _ = moe.apply_moe(p, x, cfg.replace(moe=dataclasses.replace(m, dispatch="argsort")), NO_SHARD)
    monkeypatch.setattr(ops, "bucket_count_rank", lambda ids, nb: partition_kernel.bucket_count_rank_plain(ids, nb))
    y_plain, _ = moe.apply_moe(p, x, cfg, NO_SHARD)
    assert torch.equal(y_k1, y_plain) and torch.equal(y_k1, y_argsort)


@pytest.mark.cuda
def test_cuda_ssd_chunked_equals_the_sequential_update(cuda_device):
    """Zamba2's SSD at full width (80 heads of 64, d_state 64, chunks of
    256) over 600 positions (two chunks and a padded tail) from a random
    state, on the card in float32 (no TF32): the outputs and the final
    state within 1e-3 of the decode update applied position by position,
    relative to their largest magnitude."""
    from repro_torch.configs import registry
    from repro_torch.models import ssm

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = registry.get_config("zamba2-2.7b")
    B, S, nh, hd, ds = 2, 600, cfg.ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    g = torch.Generator(device=cuda_device).manual_seed(6)
    f = lambda *s: torch.randn(s, generator=g, device=cuda_device)  # noqa: E731
    x, B_, C = f(B, S, nh, hd), f(B, S, 1, ds), f(B, S, 1, ds)
    dt, A = torch.nn.functional.softplus(f(B, S, nh)), -torch.exp(0.5 * f(nh))
    st0 = 0.5 * f(B, nh, hd, ds)
    y, final = ssm.ssd_chunked(x, dt, A, B_, C, cfg, init_state=st0)
    st, ys = st0, []
    for t in range(S):
        yt, st = ssm.ssd_step(st, x[:, t], dt[:, t], A, B_[:, t].expand(B, nh, ds), C[:, t].expand(B, nh, ds))
        ys.append(yt)
    y_seq = torch.stack(ys, 1)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    assert rel(y, y_seq) <= 1e-3 and rel(final, st) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SERVED)
def test_cuda_smoke_train_step_matches_the_cpu(arch, cuda_device):
    """One train step of the smoke config in float32 (no TF32) on the card
    and on the CPU, from the same seeded weights and batch, at the peak lr
    (no warmup): the metrics within 1e-4 of ``max(1, |value|)``; every
    parameter within ``2·lr`` (AdamW's first step moves an entry by
    ``lr·g/(|g|+ε)``, whose sign and size are rounding noise where the
    gradient is near zero) plus 1e-6 of the leaf's largest magnitude, and
    all but 1 % of the model's entries within 1 % of ``lr`` plus that.
    With remat, K1 launches twice a MoE layer."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.train_step import init_train_state, make_train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = registry.get_config(arch, smoke=True).replace(dtype=torch.float32)
    api = registry.get_model_api(cfg)
    lr = 3e-4
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"), learning_rate=lr, warmup_steps=0, total_steps=4)
    cpu = init_train_state(torch.Generator().manual_seed(0), cfg, run, api)
    card = tree_map(lambda t: t.to(cuda_device, copy=True), cpu)
    step = make_train_step(cfg, run, api)
    batch = SyntheticLMData(cfg, 2, 32, seed=0).next_batch()
    _, want = step(cpu, batch)
    reset_launches()
    _, got = step(card, tree_map(lambda t: t.to(cuda_device), batch))
    assert launch_counts()["bucket_count_rank"] == (2 * cfg.num_layers if cfg.is_moe else 0)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= 1e-4 * max(1.0, abs(float(w))), k
    outside = total = 0
    for a, b in zip(tree_leaves(card["params"]), tree_leaves(cpu["params"])):
        err, scale = (a.cpu() - b).abs(), float(b.abs().max())
        assert float(err.max()) <= 2 * lr + 1e-6 * scale
        outside += int((err > 1e-2 * lr + 1e-6 * scale).sum())
        total += err.numel()
    assert outside <= 0.01 * total


@pytest.mark.cuda
def test_cuda_checkpointer_round_trips_card_tensors(cuda_device, tmp_path):
    """Leaves on the card (float32, bf16, int32, bool) saved and restored
    onto the card bit for bit."""
    from repro_torch.ckpt.checkpointer import Checkpointer

    g = torch.Generator(device=cuda_device).manual_seed(7)
    tree = {
        "w": torch.randn((64, 33), generator=g, device=cuda_device),
        "h": torch.randn((5, 7), generator=g, device=cuda_device).to(torch.bfloat16),
        "n": [torch.arange(9, dtype=torch.int32, device=cuda_device), torch.tensor([True, False], device=cuda_device)],
    }
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(4, tree, extra={"data": {"seed": 0, "step": 4}}, async_save=True)
    tree["w"].add_(1.0)  # the save copied the leaves before returning
    ck.wait()
    out, extra = ck.restore(4, {"w": None, "h": None, "n": [None, None]}, device=cuda_device)
    assert extra == {"data": {"seed": 0, "step": 4}}
    assert torch.equal(out["w"] + 1.0, tree["w"]) and out["w"].device.type == cuda_device.type
    assert out["h"].dtype == torch.bfloat16 and torch.equal(out["h"].view(torch.int16), tree["h"].view(torch.int16))
    assert torch.equal(out["n"][0], tree["n"][0]) and torch.equal(out["n"][1], tree["n"][1])


# ------------------------------------------------------------- the perf gate
@pytest.mark.cuda
def test_cuda_calibration_reads_the_card(cuda_device):
    """The copy probe (1 GiB, twenty times the L2) reads HBM: at least
    1.0e12 B/s and no more than the data sheet's 3.35e12; the float32
    GEMM (TF32 off, and left as it was) stays under the 67e12 float32
    peak."""
    from repro_torch.roofline.hw import calibrate_host

    tf32 = torch.backends.cuda.matmul.allow_tf32
    hw = calibrate_host(device=cuda_device)
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    assert hw is calibrate_host(device="cuda")
    assert 1.0e12 <= hw.hbm_bw <= 3.35e12, hw
    assert 0 < hw.peak_bf16_flops < 67e12, hw
    assert hw.name == torch.cuda.get_device_name(cuda_device)


@pytest.mark.cuda
def test_cuda_measure_waits_for_the_card(cuda_device):
    """A call that enqueues a known stretch of device work (``_sleep``
    between two events) and returns a tensor on the card: every timed
    sample lasts at least that stretch, so the sync held; without the sync
    the samples measure the enqueue and read shorter."""
    from repro_torch.perf.measure import measure

    marker = torch.zeros(1, device=cuda_device)
    spans = []

    def call():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)  # about 10 ms at the card's clocks
        end.record()
        spans.append((start, end))
        return {"out": [marker]}

    m = measure(call, warmup=1, repeats=5)
    torch.cuda.synchronize()
    slept = [s.elapsed_time(e) / 1e3 for s, e in spans[1:]]
    assert min(slept) > 1e-3
    assert all(t >= s for t, s in zip(m.samples_s, slept)), (m.samples_s, slept)
    unsynced = measure(call, warmup=0, repeats=3, sync=None)
    torch.cuda.synchronize()
    assert unsynced.max_s < min(slept)


@pytest.mark.cuda
def test_cuda_kernels_suite_smoke_runs_on_the_card(cuda_device):
    """The kernels suite's smoke cases on the card: finite records, K2 and
    K4 launched, K6 and K7 never."""
    from repro_torch import perf
    from repro_torch.kernels import launch_counts, reset_launches

    reset_launches()
    records = perf.run_suite("kernels", smoke=True, warmup=1, repeats=3, device="cuda")
    counts = launch_counts()
    assert [r.case_id for r in records] == [c.case_id for c in perf.cases_for("kernels", smoke=True)]
    for r in records:
        assert np.isfinite(r.median_s) and r.median_s > 0 and np.isfinite(r.norm_ratio)
        assert 0 < r.pct_of_roofline <= 105.0, r
    assert counts["sort_tile"] > 0 and counts["batched_row_sort"] > 0
    assert counts["batched_row_sort_pairs"] == counts["sort_pairs_tile"] == 0
