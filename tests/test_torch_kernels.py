"""The port's kernels (``repro_torch.kernels``) against the JAX package's
Pallas kernels, which run here in interpret mode as their own tests run them.

On the CPU every wrapper runs its kernel's plain torch version, so these
tests pin the plain versions — the same networks the CUDA kernels compute —
to the TPU kernels exactly, on the same numpy inputs.  The CUDA kernels
themselves are held to these plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import batched as jbatched
from repro.kernels import bitonic as jbitonic
from repro.kernels import ops as jops
from repro_torch import dtypes
from repro_torch.kernels import (
    KERNELS,
    batched,
    bitonic,
    launch_counts,
    ops,
    partition_kernel,
    ref,
)

DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint32, np.float32)


def _keys(rng, shape, dtype):
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        # int64 keys stay inside int32: jax without x64 holds 32 bits
        lo, hi = (info.min, info.max) if dt.itemsize <= 4 else (-(2**31), 2**31 - 1)
        return rng.integers(lo, hi, shape, dtype=np.int64, endpoint=True).astype(dt)
    return rng.standard_normal(shape).astype(dt)


def _port(x):
    return dtypes.to_device(x, "cpu")


def _back(t, dtype):
    return dtypes.to_numpy(t, dtype)


def _same(a, b):
    # floats: -0.0 and +0.0 compare equal and may swap places
    if a.dtype == np.int64 and b.dtype == np.int32:
        b = b.astype(np.int64)  # jax without x64 returned the 32-bit twin
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_sort_tile_plain_matches_pallas(dtype, rng):
    x = _keys(rng, 256, dtype)
    x[::9] = x[3]  # ties
    want = np.asarray(jbitonic.sort_tile(jnp.asarray(x), interpret=True))
    _same(_back(bitonic.sort_tile(_port(x)), dtype), want)


def _select_network(x):
    """The bitonic network written by index, apart from the plain version's
    reshapes: stage (s, j) pairs i with i + 2^j (bit j of i clear), orders
    the pair ascending where bit s+1 of i is clear, and takes min and max
    by the select on b < a that the CUDA kernels use."""
    x = x.copy()
    i = np.arange(x.shape[-1])
    for s in range(x.shape[-1].bit_length() - 1):
        for j in range(s, -1, -1):
            lo = i[((i >> j) & 1) == 0]
            hi = lo + (1 << j)
            asc = ((lo >> (s + 1)) & 1) == 0
            a, b = x[:, lo], x[:, hi]
            b_lt_a = b < a
            mn, mx = np.where(b_lt_a, b, a), np.where(b_lt_a, a, b)
            x[:, lo], x[:, hi] = np.where(asc, mn, mx), np.where(asc, mx, mn)
    return x


@pytest.mark.parametrize("n", (256, 4096))
@pytest.mark.parametrize("case", ("signed_zeros", "ties_int32", "ties_int8"))
def test_sort_tile_plain_is_the_select_network_bit_for_bit(case, n, rng):
    # The chip checks hold K2 to sort_tile_plain bit for bit; this pins that
    # yardstick to the network itself where ties decide the bytes: float32
    # keys half of them -0.0 or +0.0 (equal under <, apart in their bits),
    # and integer keys from 16 values.
    if case == "signed_zeros":
        x = rng.standard_normal((3, n)).astype(np.float32)
        zero = rng.random((3, n)) < 0.5
        x[zero] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(0.0), np.float32(-0.0))
        dtype = np.float32
    else:
        dtype = np.int32 if case == "ties_int32" else np.int8
        x = rng.integers(0, 16, (3, n)).astype(dtype)
    got = bitonic.sort_tile_plain(torch.from_numpy(x)).numpy()
    want = _select_network(x)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    if case == "signed_zeros":
        assert (np.signbit(got) & (got == 0)).any() and (~np.signbit(got) & (got == 0)).any()
    for r in range(3):
        _same(got[r], np.asarray(jbitonic.sort_tile(jnp.asarray(x[r]), interpret=True)))


def test_sort_tile_rows_match_pallas_per_row(rng):
    x = _keys(rng, (3, 128), np.int16)
    got = _back(bitonic.sort_tile(_port(x)), np.int16)
    for i in range(3):
        _same(got[i], np.asarray(jbitonic.sort_tile(jnp.asarray(x[i]), interpret=True)))


@pytest.mark.parametrize("dtype", (np.int8, np.int32, np.uint32, np.float32), ids=lambda d: np.dtype(d).name)
def test_merge_tiles_plain_matches_pallas(dtype, rng):
    a = np.sort(_keys(rng, 128, dtype))
    b = np.sort(_keys(rng, 128, dtype))
    want_lo, want_hi = jbitonic.merge_tiles(jnp.asarray(a), jnp.asarray(b), interpret=True)
    lo, hi = bitonic.merge_tiles(_port(a), _port(b))
    _same(_back(lo, dtype), np.asarray(want_lo))
    _same(_back(hi, dtype), np.asarray(want_hi))


@pytest.mark.parametrize("dtype", (np.int32, np.float32), ids=lambda d: np.dtype(d).name)
def test_local_sort_multi_tile_matches_pallas(dtype, rng, monkeypatch):
    # a 128-key tile forces the odd-even merge passes at a small size:
    # 700 keys pad to 1024, eight tiles, eight half-passes
    monkeypatch.setattr(jops, "MAX_TILE", 128)
    monkeypatch.setattr(ops, "MAX_TILE", 128)
    x = _keys(rng, 700, dtype)
    want = np.asarray(jops.local_sort(jnp.asarray(x), interpret=True))
    _same(_back(ops.local_sort(_port(x)), dtype), want)
    rows = _keys(rng, (3, 300), dtype)
    got = _back(ops.local_sort(_port(rows)), dtype)
    for i in range(3):
        _same(got[i], np.sort(rows[i]))


def test_merge_tile_pairs_odd_half_pass_leaves_the_ends(rng):
    tiles = np.sort(_keys(rng, (2, 4, 128), np.int32), axis=-1)
    buf = torch.from_numpy(tiles.copy())
    bitonic.merge_tile_pairs(buf, 1)
    out = buf.numpy()
    _same(out[:, 0], tiles[:, 0])
    _same(out[:, 3], tiles[:, 3])
    for r in range(2):
        _same(out[r, 1:3].ravel(), np.sort(tiles[r, 1:3].ravel()))


def _csrc_constant(name, source):
    """The value of ``constexpr int name`` in ``csrc/<source>``."""
    text = (Path(bitonic.__file__).parent / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (-?\d+);", text).group(1))


def _key_tier_constants():
    """(LOG_E, log2 chunk keys) of the key tiers (csrc/key_tiers.cuh) for
    each key dtype, computed from its constants as key_log_e / key_log_chunk
    do."""
    log_e = _csrc_constant("kLogKeyE", "key_tiers.cuh")
    chunk_bytes = _csrc_constant("kLogKeyChunkBytes", "key_tiers.cuh")
    out = {}
    for dt in (torch.int8, torch.int16, torch.int32, torch.int64, torch.float32):
        log_size = torch.empty((), dtype=dt).element_size().bit_length() - 1
        e = max(log_e, 4 - log_size)
        out[dt] = e, min(chunk_bytes - log_size, e + 10)
    return out


def _cx(a, b, asc, two_op=False):
    """The pair (a, b) as the kernels leave it: min and max by the select on
    b < a (max as a + b - min, wrapping, with ``two_op``)."""
    b_lt_a = b < a
    mn = torch.where(b_lt_a, b, a)
    mx = a + b - mn if two_op else torch.where(b_lt_a, a, b)
    return torch.where(asc, mn, mx), torch.where(asc, mx, mn)


def _held_cx(k, cells, bit, s, two_op=False):
    """Held key r meets r + 2^bit in every thread (k: (segs, threads, E)),
    the pair left as the kernels leave it; the direction is bit s+1 of the
    lower key's index in its segment (``cells``: (threads, E))."""
    e = k.shape[-1]
    r = torch.arange(e)
    lo = r[(r >> bit) & 1 == 0]
    hi = lo + (1 << bit)
    asc = ((cells[:, lo] >> (s + 1)) & 1) == 0
    k[..., lo], k[..., hi] = _cx(k[..., lo], k[..., hi], asc, two_op)


def _distance(x, s, j, two_op=False):
    """Distance 2^j of stage s on every pair (i, i + 2^j) of each row of x,
    the direction from bit s+1 of i: what a chunk launch's tiers do to
    every pair of a distance below the chunk."""
    i = torch.arange(x.shape[-1])
    lo = i[(i >> j) & 1 == 0]
    hi = lo + (1 << j)
    asc = ((lo >> (s + 1)) & 1) == 0
    x[:, lo], x[:, hi] = _cx(x[:, lo], x[:, hi], asc, two_op)


def _window_cells(n, log_e, jb):
    """Each thread's cells in a window with register bits jb .. jb+log_e-1
    (spread(u, jb) + (r << jb)), checked to cover the n cells once."""
    u = torch.arange(n >> log_e)
    base = ((u >> jb) << (jb + log_e)) | (u & ((1 << jb) - 1))
    cells = base[:, None] + (torch.arange(1 << log_e) << jb)
    assert torch.equal(torch.bincount(cells.reshape(-1), minlength=n), torch.ones(n, dtype=torch.long))
    return cells


def _k3_schedule_model(x, log_e, log_c):
    """csrc/bitonic.cu's merge (K3) on segments ``x`` (segs, 2^log_seg),
    each holding two sorted tiles, by the kernels' index arithmetic."""
    x = x.clone()
    n = x.shape[-1]
    log_seg = n.bit_length() - 1
    s, m, e = log_seg - 1, n // 2, 1 << log_e
    if log_seg <= log_c:
        # one chunk launch: home runs of the upper half read from the
        # mirrored run (3M - E - g0), reversed
        g0 = torch.arange(0, n, e)
        src = torch.where(g0 >= m, 3 * m - e - g0, g0)[:, None] + torch.arange(e)
        src = torch.where(g0[:, None] >= m, src.flip(-1), src)
        x = x[:, src.reshape(-1)]
        j0 = s
    else:
        # key_device_flip: thread l holds cells l + rQ and l' + rQ, l' = Q-1-l
        q = n // 8
        l = torch.arange(q // 2)
        r = torch.arange(8) * q
        ca, cb = l[:, None] + r, (q - 1 - l)[:, None] + r
        assert torch.equal(torch.bincount(torch.cat([ca, cb]).reshape(-1), minlength=n), torch.ones(n, dtype=torch.long))
        a, b = x[:, ca], x[:, cb]
        up = [7, 6, 5, 4]
        xa, xb = torch.cat([a[..., :4], b[..., up]], -1), torch.cat([b[..., :4], a[..., up]], -1)
        jflip = max(s - 2, log_c)
        for j in range(s, jflip - 1, -1):
            for k, cells in ((xa, ca), (xb, cb)):
                _held_cx(k, cells, j - (log_seg - 3), s)
        x[:, ca], x[:, cb] = xa, xb
        # key_device_window: LOG_E distances a launch, register bits jb..
        jhi = jflip - 1
        while jhi >= log_c:
            jlo = max(jhi - (log_e - 1), log_c)
            jb = min(jlo, log_seg - log_e)
            cells = _window_cells(n, log_e, jb)
            k = x[:, cells]
            for j in range(jhi, jlo - 1, -1):
                _held_cx(k, cells, j - jb, s)
            x[:, cells] = k
            jhi = jlo - 1
        j0 = log_c - 1
    # key_chunk_stages: the distances below the chunk, each on every pair
    for j in range(j0, -1, -1):
        _distance(x, s, j)
    return x


K3_MODEL_CASES = [
    (torch.int8, "ties"), (torch.int16, "ties"), (torch.int32, "ties"), (torch.int64, "ties"),
    (torch.float32, "signed_zeros"),
]


@pytest.mark.parametrize("log_seg", range(8, 22))
@pytest.mark.parametrize("dtype,case", K3_MODEL_CASES, ids=[f"{str(d)[6:]}-{c}" for d, c in K3_MODEL_CASES])
def test_k3_schedule_model_is_the_plain_merge_bit_for_bit(dtype, case, log_seg, rng):
    # The CUDA merge's tiers (the flip window, device windows, one chunk
    # launch), modelled by their index sets and held to the plain network
    # before any chip run: 16-value ties and float32 keys half of them
    # -0.0 or +0.0, where a wrong schedule shows in the bytes.
    log_e, log_c = _key_tier_constants()[dtype]
    m = 1 << (log_seg - 1)
    rows, tiles, first = (2, 3, log_seg % 2) if log_seg <= 12 else (1, 2, 0)
    if case == "ties":
        raw = rng.integers(0, 16, (rows, tiles, m))
    else:
        raw = rng.standard_normal((rows, tiles, m)).astype(np.float32)
        zero = rng.random(raw.shape) < 0.5
        raw[zero] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(0.0), np.float32(-0.0))
    buf = torch.sort(torch.from_numpy(raw).to(dtype), dim=-1).values
    want = bitonic.merge_tile_pairs_plain(buf.clone(), first)
    # every segment of the half-pass, addressed as rt::seg_offset does
    flat = buf.clone().reshape(-1)
    per_row = (tiles - first) // 2
    seg = torch.arange(rows * per_row)
    offs = (seg // per_row) * tiles * m + first * m + (seg % per_row) * 2 * m
    cells = offs[:, None] + torch.arange(2 * m)
    flat[cells] = _k3_schedule_model(flat[cells], log_e, log_c)
    got = flat.view(rows, tiles, m)
    assert torch.equal(got.view(torch.int32) if dtype == torch.float32 else got,
                       want.view(torch.int32) if dtype == torch.float32 else want)
    if case == "signed_zeros":
        assert (torch.signbit(got) & (got == 0)).any() and (~torch.signbit(got) & (got == 0)).any()


@pytest.fixture
def one_torch_thread():
    """The schedule models run many indexing ops on small rows; with several
    test workers on one machine, torch's intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _filled_runs(x, lens, e, fill):
    """The fill on load of K4 / K6, home run by home run (E keys at g0): a
    run wholly at or past its row's length is not read (all ``fill``); one
    that straddles it is read, then selected key by key on the signed
    pos < len.  Returns the filled rows and the pad mask."""
    rows, n = x.shape
    g0 = torch.arange(0, n, e)
    lens = lens.to(torch.int64)[:, None]
    unread = g0[None, :] >= lens  # (rows, runs)
    straddle = ~unread & (g0[None, :] + e > lens)
    pos = g0[:, None] + torch.arange(e)  # (runs, E)
    pad = unread[..., None] | (straddle[..., None] & (pos[None] >= lens[..., None]))
    out = x.reshape(rows, -1, e).clone()
    out[unread] = fill  # never read: garbage there cannot show
    out[pad] = fill
    return out.reshape(rows, n), pad.reshape(rows, n)


def _k4_schedule_model(x, lens, log_e, log_c, two_op):
    """csrc/batched.cu's row sort (K4) on rows ``x`` (rows, L), by the
    kernels' index arithmetic: the first chunk launch fills on load and
    runs stages 0 .. log_c-1 on each chunk; each later stage takes device
    windows of LOG_E distances (register bits jb ..) down to the chunk,
    then one chunk launch for its distances below the chunk."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    log_c = min(log_c, log_n)
    x, _ = _filled_runs(x, lens, 1 << log_e, dtypes.max_sentinel(x.dtype))
    for s in range(log_n):
        jhi = s
        while jhi >= log_c:
            jlo = max(jhi - (log_e - 1), log_c)
            jb = min(jlo, log_n - log_e)
            cells = _window_cells(n, log_e, jb)
            k = x[:, cells]
            for j in range(jhi, jlo - 1, -1):
                _held_cx(k, cells, j - jb, s, two_op)
            x[:, cells] = k
            jhi = jlo - 1
        for j in range(min(s, log_c - 1), -1, -1):
            _distance(x, s, j, two_op)
    return x


def _row_lengths(n):
    # empty, one key, around a 16-key home run, one short of the row, the
    # row, and the plain version's signed compare past both ends
    return torch.tensor([0, 1, 15, 16, 17, n - 1, n, -3, n + 5], dtype=torch.int32)


def _model_keys(rng, shape, dtype):
    """Keys from 16 values (ties), some equal to the dtype-max sentinel;
    float32 keys with -0.0 and +0.0 among them."""
    raw = rng.integers(0, 16, shape)
    if dtype == torch.float32:
        x = torch.from_numpy((raw - 8).astype(np.float32))
        x[torch.from_numpy(raw == 15)] = float("inf")
        zero = torch.from_numpy((raw == 8) & (rng.random(shape) < 0.5))
        x[zero] = -0.0
        return x
    x = torch.from_numpy(raw).to(dtype)
    x[torch.from_numpy(raw == 15)] = torch.iinfo(dtype).max
    return x


def _garbage_pads(rng, x, lens):
    """Full-range garbage at and past each row's length."""
    pos = torch.arange(x.shape[-1])
    pad = pos[None, :] >= lens.to(torch.int64)[:, None]
    junk = torch.from_numpy(_keys(rng, tuple(x.shape), np.dtype(str(x.dtype)[6:])))
    return torch.where(pad, junk, x)


def _bits_of(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


K4_MODEL_CASES = [
    (dt, log_n)
    for dt in (torch.int8, torch.int16, torch.int32, torch.int64, torch.float32)
    for log_n in range(7, 17 - (torch.empty((), dtype=dt).element_size().bit_length() - 1))
]


@pytest.mark.parametrize("method", batched.METHODS)
@pytest.mark.parametrize("dtype,log_n", K4_MODEL_CASES, ids=[f"{str(d)[6:]}-2^{k}" for d, k in K4_MODEL_CASES])
def test_k4_schedule_model_is_the_plain_row_sort_bit_for_bit(dtype, log_n, method, rng, one_torch_thread):
    # The CUDA row sort's fill on load, chunk launches and device windows,
    # modelled by their index sets and held to the plain version before any
    # chip run, at every row length up to 64 KiB a row: 16-value ties,
    # float32 signed zeros, keys equal to the sentinel, garbage in the pads.
    n = 1 << log_n
    lens = _row_lengths(n)
    x = _garbage_pads(rng, _model_keys(rng, (lens.numel(), n), dtype), lens)
    log_e, log_c = _key_tier_constants()[dtype]
    two_op = method == "bitonic2op" and not dtype.is_floating_point
    got = _k4_schedule_model(x, lens, log_e, log_c, two_op)
    want = batched.batched_row_sort_plain(x, lens, method=method)
    assert torch.equal(_bits_of(got), _bits_of(want))
    if dtype == torch.float32:
        assert (torch.signbit(got) & (got == 0)).any() and (~torch.signbit(got) & (got == 0)).any()


def _pair_cx(k, t, v, lo, hi, asc):
    """The reference's (tag, key) exchange on the pairs at index sets lo and
    hi of the last axis, in place; ties never swap."""
    ka, kb, ta, tb = k[..., lo], k[..., hi], t[..., lo], t[..., hi]
    gt = (ta > tb) | ((ta == tb) & (ka > kb))
    lt = (ta < tb) | ((ta == tb) & (ka < kb))
    swap = torch.where(asc, gt, lt)
    for z in (k, t, v):
        a, b = z[..., lo], z[..., hi]
        z[..., lo], z[..., hi] = torch.where(swap, b, a), torch.where(swap, a, b)


def _k6_schedule_model(k, v, lens, log_e, log_b, log_t):
    """csrc/batched.cu's pair row sort (K6, pair_chunk_rows) on rows
    (rows, L), by the kernel's index arithmetic: a cluster of 2^log_b
    blocks a row, each holding a span of it; threads take home runs of
    2^log_e pairs in turn, filled on load; stages within a warp's 32 runs
    run on them; each later stage takes its distances past the span
    between the blocks (each block a share of the row's pairs), then
    shared-memory windows of log_e distances in each span (each thread
    taking bases u = t, t + threads, ...), then the distances within a
    warp's runs again."""
    rows, n = k.shape
    log_n = n.bit_length() - 1
    log_span = log_n - log_b
    span = 1 << log_span
    e, nt = 1 << log_e, 1 << min(log_t, log_span - log_e)
    log_w = min(log_span, log_e + 5)
    # pass q, thread t of a block holds run q*nt + t of its span: a warp's
    # 32 lanes (or all of a smaller block) hold consecutive runs, so every
    # shuffle partner (distance below 2^log_w) sits in the same pass
    run = torch.arange(span // (e * nt))[:, None] * nt + torch.arange(nt)
    assert torch.equal(run.reshape(-1), torch.arange(span // e))
    lanes = run.reshape(-1, min(nt, 32))
    assert torch.equal(lanes - lanes[:, :1], torch.arange(min(nt, 32)).expand_as(lanes))
    assert ((lanes[:, 0] * e) % (1 << log_w) == 0).all()
    k, pad = _filled_runs(k, lens, e, dtypes.max_sentinel(k.dtype))
    v = torch.where(pad, torch.zeros((), dtype=v.dtype), v)
    t = pad.to(torch.uint8)
    i = torch.arange(n)

    def within_warp(s, jhi):
        for j in range(jhi, -1, -1):
            lo = i[(i >> j) & 1 == 0]
            _pair_cx(k, t, v, lo, lo + (1 << j), ((lo >> (s + 1)) & 1) == 0)

    for s in range(log_w):
        within_warp(s, s)
    for s in range(log_w, log_n):
        j = s
        while j >= log_span:
            # block b takes pairs p of [b, b + 1) * n / 2^(log_b + 1)
            p = torch.arange(n // 2)
            lo = ((p >> j) << (j + 1)) | (p & ((1 << j) - 1))
            assert torch.equal(torch.bincount(torch.cat([lo, lo + (1 << j)]), minlength=n), torch.ones(n, dtype=torch.long))
            _pair_cx(k, t, v, lo, lo + (1 << j), ((lo >> (s + 1)) & 1) == 0)
            j -= 1
        while j >= log_w:
            jlo = max(j - (log_e - 1), log_w)
            jb = min(jlo, log_span - log_e)
            cells = torch.cat([b * span + _window_cells(span, log_e, jb) for b in range(1 << log_b)])
            for jj in range(j, jlo - 1, -1):
                r = torch.arange(e)
                rl = r[(r >> (jj - jb)) & 1 == 0]
                lo, hi = cells[:, rl].reshape(-1), cells[:, rl + (1 << (jj - jb))].reshape(-1)
                _pair_cx(k, t, v, lo, hi, ((lo >> (s + 1)) & 1) == 0)
            j = jlo - 1
        within_warp(s, log_w - 1)
    return k, v


K6_MODEL_CASES = [
    (dt, vdt, log_n)
    for dt, vdt in ((torch.int8, torch.int32), (torch.int16, torch.int32), (torch.int32, torch.int32),
                    (torch.int64, torch.float64), (torch.float32, torch.int32))
    for log_n in range(7, 18)
    if (torch.empty((), dtype=dt).element_size() + torch.empty((), dtype=vdt).element_size() + 1) << log_n
    <= batched.MAX_PAIR_ROW_BYTES
]


@pytest.mark.parametrize(
    "dtype,vdtype,log_n", K6_MODEL_CASES, ids=[f"{str(d)[6:]}-{str(w)[6:]}-2^{k}" for d, w, k in K6_MODEL_CASES]
)
def test_k6_schedule_model_is_the_plain_pair_row_sort_bit_for_bit(dtype, vdtype, log_n, rng, one_torch_thread):
    # The same for the pair row sort, at every row length one block's shared
    # memory takes: ties broken by payload order show a wrong schedule.
    n = 1 << log_n
    lens = _row_lengths(n)
    k = _garbage_pads(rng, _model_keys(rng, (lens.numel(), n), dtype), lens)
    v = torch.from_numpy(rng.integers(-(2**62), 2**62, (lens.numel(), n))).to(bitonic._BITS[
        torch.empty((), dtype=vdtype).element_size()]).view(vdtype)
    log_e = _csrc_constant("kLogE", "pair_tiers.cuh")
    got_k, got_v = _k6_schedule_model(k, v, lens, log_e, _csrc_constant("kLogRowPairBlocks", "batched.cu"),
                                      _csrc_constant("kLogRowPairThreads", "batched.cu"))
    want_k, want_v = batched.batched_row_sort_pairs_plain(k, v, lens)
    bits = bitonic._BITS[v.element_size()]
    assert torch.equal(_bits_of(got_k), _bits_of(want_k))
    assert torch.equal(got_v.view(bits), want_v.view(bits))


@pytest.mark.parametrize("chunk", (1, 300, 1234, 5000))
def test_bucket_count_rank_chunk_carry_is_one_pass(chunk, rng):
    # The card's launches past MAX_KERNEL_IDS ids, driven here by the plain
    # version: each chunk's ranks gain the counts of the chunks before it,
    # out-of-range ids stay rank 0 and uncounted.
    ids = torch.from_numpy(rng.integers(-2, 9, 5000).astype(np.int32))
    ids[::97] = -(2**31)
    got = partition_kernel.carry_chunks(ids, 7, partition_kernel.bucket_count_rank_plain, chunk)
    want = partition_kernel.bucket_count_rank_plain(ids, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize(
    "n,num_buckets,case",
    [(0, 4, "empty"), (1, 1, "one"), (1000, 7, "ragged"), (3000, 16, "tiles"), (2048, 5, "out_of_range")],
)
def test_bucket_count_rank_plain_matches_pallas(n, num_buckets, case, rng):
    ids = rng.integers(0, num_buckets, n).astype(np.int32)
    if case == "out_of_range":
        # not counted and rank 0 on both sides, and nothing written past counts
        ids[::5] = -1
        ids[1::5] = num_buckets
    want_c, want_r = jops.bucket_count_rank(jnp.asarray(ids), num_buckets, interpret=True)
    got_c, got_r = partition_kernel.bucket_count_rank(torch.from_numpy(ids), num_buckets)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    ref_c, ref_r = ref.ref_bucket_count_rank(torch.from_numpy(ids), num_buckets)
    np.testing.assert_array_equal(got_c.numpy(), ref_c.numpy())
    np.testing.assert_array_equal(got_r.numpy(), ref_r.numpy())


def test_bucket_count_rank_plain_chunks_carry_counts(rng, monkeypatch):
    monkeypatch.setattr(partition_kernel, "_PLAIN_CHUNK", 100)
    ids = torch.from_numpy(rng.integers(0, 6, 1234).astype(np.int32))
    got = partition_kernel.bucket_count_rank(ids, 6)
    want = ref.ref_bucket_count_rank(ids, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bucket_count_rank_debug_range_check():
    ids = np.array([0, 3, 5, -1], np.int32)
    with pytest.raises(ValueError, match="out of range"):
        jops.bucket_count_rank(jnp.asarray(ids), 4, interpret=True, debug=True)
    with pytest.raises(ValueError, match="out of range"):
        partition_kernel.bucket_count_rank(torch.from_numpy(ids), 4, debug=True)


def _row_batch(rng, dtype, length):
    lens = np.array([0, 1, 127, 128, 129, 200, 255, 256, 256, 3], np.int32)
    x = _keys(rng, (lens.size, length), dtype)  # garbage in the pad cells
    sentinel = np.iinfo(dtype).max if np.issubdtype(np.dtype(dtype), np.integer) else np.inf
    x[8] = sentinel  # a full row of keys equal to the sentinel
    x[5, ::3] = sentinel  # sentinel ties inside a row
    return x, lens


@pytest.mark.parametrize("method", batched.METHODS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_batched_row_sort_plain_matches_pallas(dtype, method, rng):
    x, lens = _row_batch(rng, dtype, 256)
    got = _back(batched.batched_row_sort(_port(x), torch.from_numpy(lens), method=method), dtype)
    for i, n in enumerate(lens):
        _same(got[i, :n], np.sort(x[i, :n]))
    if np.dtype(dtype) == np.int64:
        # jax without x64 holds 32 bits and so another sentinel: np.sort
        # and the int64 sentinel tail are the oracle
        assert (got == np.where(np.arange(256) < lens[:, None], got, np.iinfo(np.int64).max)).all()
        return
    want = np.asarray(
        jbatched.batched_row_sort(jnp.asarray(x), jnp.asarray(lens), method=method, interpret=True)
    )
    _same(got, want)


@pytest.mark.parametrize(
    "call,err",
    [
        (lambda: bitonic.sort_tile(torch.zeros(96, dtype=torch.int32)), ValueError),
        (lambda: bitonic.sort_tile(torch.zeros(384, dtype=torch.int32)), ValueError),
        (lambda: bitonic.sort_tile(torch.zeros(128, dtype=torch.float64)), TypeError),
        (lambda: bitonic.merge_tiles(torch.zeros(128, dtype=torch.int32), torch.zeros(256, dtype=torch.int32)), ValueError),
        (lambda: batched.batched_row_sort(torch.zeros(2, 128, dtype=torch.int32), torch.zeros(2, dtype=torch.int64)), ValueError),
        (lambda: batched.batched_row_sort(torch.zeros(2, 16384, dtype=torch.int64), torch.zeros(2, dtype=torch.int32)), ValueError),
        (lambda: batched.batched_row_sort(torch.zeros(2, 128, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), method="quick"), ValueError),
        (lambda: partition_kernel.bucket_count_rank(torch.zeros(4, dtype=torch.int64), 3), ValueError),
        (lambda: partition_kernel.bucket_count_rank(torch.zeros(4, dtype=torch.int32), partition_kernel.MAX_BUCKETS + 1), ValueError),
    ],
    ids=["not_lanes", "not_pow2", "float64", "merge_shapes", "lens_dtype", "row_too_long", "method", "ids_dtype", "too_many_buckets"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()


def test_cpu_tensors_launch_nothing(rng):
    before = launch_counts()
    x = torch.from_numpy(_keys(rng, (2, 256), np.int32))
    bitonic.sort_tile(x)
    bitonic.merge_tiles(x[0].sort().values, x[1].sort().values)
    batched.batched_row_sort(x, torch.tensor([3, 256], dtype=torch.int32))
    partition_kernel.bucket_count_rank(torch.zeros(10, dtype=torch.int32), 2)
    assert launch_counts() == before
    assert set(before) == set(KERNELS)


@pytest.mark.parametrize("dtype", (np.uint8, np.uint16, np.uint32, np.uint64), ids=lambda d: np.dtype(d).name)
def test_unsigned_boundary_keeps_order_and_sentinel(dtype, rng):
    info = np.iinfo(dtype)
    x = rng.integers(0, info.max, 500, dtype=dtype, endpoint=True)
    x[:3] = [0, info.max, info.max // 2 + 1]
    k = dtypes.to_keys(x)
    assert k.dtype == dtypes.key_dtype(dtype) and np.issubdtype(k.dtype, np.signedinteger)
    np.testing.assert_array_equal(np.argsort(k, kind="stable"), np.argsort(x, kind="stable"))
    assert k[1] == np.iinfo(k.dtype).max
    back = dtypes.from_keys(k, dtype)
    assert back.dtype == x.dtype and np.array_equal(back, x)
    t = dtypes.to_user_tensor(torch.from_numpy(k), dtype)
    assert np.array_equal(t.numpy(), x)


@pytest.mark.parametrize("dtype", (np.int32, np.int64, np.float32, np.uint8, np.uint32, np.uint64),
                         ids=lambda d: np.dtype(d).name)
def test_key_maps_into_a_given_block(dtype, rng):
    x = rng.integers(0, 100, 300).astype(dtype)
    block = torch.empty(300, dtype=dtypes.key_torch_dtype(dtype)).numpy()
    assert block.dtype == dtypes.key_dtype(dtype)
    assert dtypes.to_keys(x, out=block) is block
    np.testing.assert_array_equal(block, dtypes.to_keys(x))
    back = dtypes.from_keys(block, dtype, inplace=True)
    assert back.dtype == x.dtype and np.array_equal(back, x) and np.shares_memory(back, block)
