"""Bitonic tile sort and two-tile merge: CUDA kernels plus their plain
torch versions.

Counterpart of ``repro.kernels.bitonic`` (Pallas TPU).  The kernels live
in ``csrc/bitonic.cu``; this module validates, allocates, launches on the
current stream and counts launches.  A wrapper given a CPU tensor runs the
plain version kept here — the same reshape-based compare-exchange network
as the reference, stage for stage — and given a CUDA tensor launches the
kernel or raises.  ``*_plain`` can also be called on CUDA tensors, so a
run on the card can hold the kernel against it.

* :func:`sort_tile` sorts every row of a ``(n,)`` or ``(rows, n)`` batch
  (``bitonic_sort_kernel``, one launch for the whole batch).
* :func:`merge_tile_pairs` merges, in place, adjacent pairs of sorted tiles
  of a ``(rows, tiles, tile)`` buffer — every pair of one odd-even
  half-pass in one launch (``bitonic_merge_kernel``).
  :func:`merge_tiles` is the two-tile form ``(a, b) -> (lo, hi)``.
* :func:`sort_pairs_tile_tagged` sorts ``(key, payload)`` pairs of every
  row on the lexicographic ``(validity tag, key)``
  (``bitonic_sort_pairs_tagged_kernel``); :func:`sort_pairs_tile` on the
  key alone (``bitonic_sort_pairs_kernel``).  One launch sorts every row.
  The payload may be of any dtype of 1, 2, 4 or 8 bytes: it travels as a
  bit view of the integer type of its width, so bool, half, bfloat16,
  float64, -0.0 and NaN patterns come out unchanged.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launches

LANES = 128

DTYPE_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3, torch.float32: 4}


def _log2(n: int) -> int:
    k = n.bit_length() - 1
    if n <= 0 or 1 << k != n:
        raise ValueError(f"{n} is not a power of two")
    return k


def check_tile(n: int) -> int:
    """``log2(n)`` for a tile length the kernels take: a power-of-two
    multiple of ``LANES``, as the reference's tiles are."""
    if n % LANES:
        raise ValueError(f"n={n} must be a multiple of {LANES}")
    return _log2(n)


def check_keys(x: torch.Tensor, what: str) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not in {tuple(DTYPE_CODES)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: device {x.device} is neither cpu nor cuda")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{what}: the kernel takes contiguous tensors only")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


# ----------------------------------------------------------- plain network
def _compare_exchange(x: torch.Tensor, s: int, j: int, *, two_op: bool = False) -> torch.Tensor:
    """One bitonic stage on the last axis: block 2**(s+1), distance 2**j.

    min/max are the selects the kernels use (``b < a``), so both agree bit
    for bit.  ``two_op`` is the NICE stage ``max = a + b - min`` (integer
    keys; torch's integer sums wrap)."""
    *lead, n = x.shape
    d = 1 << j
    y = x.reshape(*lead, n // (2 * d), 2, d)
    a, b = y[..., 0, :], y[..., 1, :]
    q = torch.arange(n // (2 * d), device=x.device)
    asc = (((q >> (s - j)) & 1) == 0)[:, None]
    b_lt_a = b < a
    mn = torch.where(b_lt_a, b, a)
    mx = a + b - mn if two_op else torch.where(b_lt_a, a, b)
    lo = torch.where(asc, mn, mx)
    hi = torch.where(asc, mx, mn)
    return torch.stack([lo, hi], dim=-2).reshape(x.shape)


def _sort_network(x: torch.Tensor, *, two_op: bool = False) -> torch.Tensor:
    kbits = _log2(x.shape[-1])
    for s in range(kbits):
        for j in range(s, -1, -1):
            x = _compare_exchange(x, s, j, two_op=two_op)
    return x


def _merge_network(x: torch.Tensor) -> torch.Tensor:
    """Final merge phase only: x must already be bitonic along the last axis."""
    kbits = _log2(x.shape[-1])
    s = kbits - 1
    for j in range(s, -1, -1):
        x = _compare_exchange(x, s, j)
    return x


# ---------------------------------------------------------------- sort_tile
def sort_tile_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sort_tile` (any device)."""
    check_keys(x, "sort_tile")
    check_tile(x.shape[-1])
    return _sort_network(x)


def sort_tile(x: torch.Tensor) -> torch.Tensor:
    """Sort the last axis of a ``(n,)`` or ``(rows, n)`` tensor ascending.

    ``n`` is a power-of-two multiple of 128.  One launch sorts every row.
    """
    check_keys(x, "sort_tile")
    if x.dim() not in (1, 2):
        raise ValueError(f"sort_tile takes (n,) or (rows, n), got {tuple(x.shape)}")
    log_n = check_tile(x.shape[-1])
    if x.device.type == "cpu":
        return _sort_network(x)
    out = torch.empty_like(x)
    rows = x.numel() >> log_n
    if rows:
        lib = _build.load("bitonic")
        code = lib.rt_sort_rows(
            DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), rows, log_n, stream_handle()
        )
        _build.check(lib, code, "sort_tile")
        _launches.count(sort_tile)
    return out


sort_tile.launches = 0


# -------------------------------------------------------------- merge_tiles
def _pairs(buf: torch.Tensor, first: int) -> int:
    if buf.dim() != 3:
        raise ValueError(f"merge_tile_pairs takes (rows, tiles, tile), got {tuple(buf.shape)}")
    if first not in (0, 1):
        raise ValueError(f"first must be 0 or 1, got {first}")
    check_tile(buf.shape[-1])
    return (buf.shape[1] - first) // 2


def merge_tile_pairs_plain(buf: torch.Tensor, first: int = 0) -> torch.Tensor:
    """Plain version of :func:`merge_tile_pairs` (any device, in place)."""
    check_keys(buf, "merge_tile_pairs")
    k = _pairs(buf, first)
    if k == 0 or buf.shape[0] == 0:
        return buf
    rows, _, m = buf.shape
    seg = buf[:, first : first + 2 * k].view(rows, k, 2, m)
    merged = _merge_network(torch.cat([seg[:, :, 0], seg[:, :, 1].flip(-1)], dim=-1))
    seg[:, :, 0] = merged[..., :m]
    seg[:, :, 1] = merged[..., m:]
    return buf


def merge_tile_pairs(buf: torch.Tensor, first: int = 0) -> torch.Tensor:
    """Merge tiles ``first + 2k`` and ``first + 2k + 1`` of every row in place.

    ``buf`` is ``(rows, tiles, tile)`` with every tile sorted; afterwards
    each merged pair holds the sorted union, the lower half in the first
    tile.  ``first = 0`` and ``1`` are the even and odd half-passes of the
    odd-even transposition that ``ops.local_sort`` runs over its tiles.
    """
    check_keys(buf, "merge_tile_pairs")
    k = _pairs(buf, first)
    if buf.device.type == "cpu":
        return merge_tile_pairs_plain(buf, first)
    rows, tiles, m = buf.shape
    if k and rows:
        lib = _build.load("bitonic")
        base = buf.data_ptr() + first * m * buf.element_size()
        code = lib.rt_merge_pairs(
            DTYPE_CODES[buf.dtype], base, rows, tiles * m, k, check_tile(m) + 1, stream_handle()
        )
        _build.check(lib, code, "merge_tile_pairs")
        _launches.count(merge_tile_pairs)
    return buf


merge_tile_pairs.launches = 0


def _stack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError("merge_tiles: a and b differ in shape, dtype or device")
    if a.dim() not in (1, 2):
        raise ValueError(f"merge_tiles takes (n,) or (rows, n), got {tuple(a.shape)}")
    return torch.stack([a, b], dim=-2).reshape(-1, 2, a.shape[-1])


def merge_tiles_plain(a: torch.Tensor, b: torch.Tensor):
    buf = merge_tile_pairs_plain(_stack(a, b))
    return buf[:, 0].reshape(a.shape), buf[:, 1].reshape(a.shape)


def merge_tiles(a: torch.Tensor, b: torch.Tensor):
    """Merge two sorted equal-length tiles → ``(lo, hi)``, rows at a time."""
    buf = merge_tile_pairs(_stack(a, b))
    return buf[:, 0].reshape(a.shape), buf[:, 1].reshape(a.shape)


# ------------------------------------------------------------- pair sorts
# Payloads cross the kernels as raw bits of their width.
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _pair_stage(k, t, v, s: int, j: int):
    """One stage of the pair network on the last axis, moving tag and
    payload with the key: the reference's ``_compare_exchange_tagged``
    (``t`` a uint8 tag tensor) or ``_compare_exchange_pairs`` (``t`` None).
    Ties never swap."""
    *lead, n = k.shape
    d = 1 << j
    shape = (*lead, n // (2 * d), 2, d)
    ky, vy = k.reshape(shape), v.reshape(shape)
    ka, kb = ky[..., 0, :], ky[..., 1, :]
    q = torch.arange(n // (2 * d), device=k.device)
    asc = (((q >> (s - j)) & 1) == 0)[:, None]
    if t is None:
        a_gt_b, a_lt_b = ka > kb, ka < kb
    else:
        ty = t.reshape(shape)
        ta, tb = ty[..., 0, :], ty[..., 1, :]
        eq = ta == tb
        a_gt_b = (ta > tb) | (eq & (ka > kb))
        a_lt_b = (ta < tb) | (eq & (ka < kb))
    swap = torch.where(asc, a_gt_b, a_lt_b)

    def move(y):
        a, b = y[..., 0, :], y[..., 1, :]
        lo = torch.where(swap, b, a)
        hi = torch.where(swap, a, b)
        return torch.stack([lo, hi], dim=-2).reshape(*lead, n)

    return move(ky), None if t is None else move(t.reshape(shape)), move(vy)


def _pair_network(k, t, v):
    kbits = _log2(k.shape[-1])
    for s in range(kbits):
        for j in range(s, -1, -1):
            k, t, v = _pair_stage(k, t, v, s, j)
    return k, v


def payload_bits(vals: torch.Tensor, what: str) -> torch.Tensor:
    """``vals`` viewed as the signed integer type of its width."""
    bits = _BITS.get(vals.element_size())
    if bits is None:
        raise TypeError(f"{what}: payload dtype {vals.dtype} is not 1, 2, 4 or 8 bytes wide")
    return vals.view(bits)


def _check_pairs(keys, vals, tags, what: str) -> int:
    check_keys(keys, what)
    if keys.dim() not in (1, 2):
        raise ValueError(f"{what} takes (n,) or (rows, n), got {tuple(keys.shape)}")
    for name, x in (("vals", vals), ("tags", tags)):
        if x is None:
            continue
        if x.shape != keys.shape:
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, keys {tuple(keys.shape)}")
        if x.device != keys.device:
            raise ValueError(f"{what}: {name} and keys lie on different devices")
        if keys.device.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors only")
    if tags is not None and (tags.is_floating_point() or tags.is_complex()):
        raise TypeError(f"{what}: tags must be bool or integer 0/1, got {tags.dtype}")
    return check_tile(keys.shape[-1])


def _tag_bytes(tags: torch.Tensor) -> torch.Tensor:
    return tags if tags.dtype == torch.uint8 else tags.to(torch.uint8)


def _launch_pairs(wrapper, keys, tags, vals):
    """Launch ``rt_sort_pairs_rows`` on CUDA tensors (tags None: untagged)
    and count the launch on ``wrapper``; nothing launches for 0 rows."""
    what = wrapper.__name__
    vbits = payload_bits(vals, what)
    log_n = check_tile(keys.shape[-1])
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vbits)
    rows = keys.numel() >> log_n
    if rows:
        lib = _build.load("bitonic")
        scratch = None if tags is None else torch.empty_like(tags)
        code = lib.rt_sort_pairs_rows(
            DTYPE_CODES[keys.dtype],
            vbits.element_size(),
            int(tags is not None),
            keys.data_ptr(),
            None if tags is None else tags.data_ptr(),
            vbits.data_ptr(),
            out_k.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            out_v.data_ptr(),
            rows,
            log_n,
            stream_handle(),
        )
        _build.check(lib, code, what)
        _launches.count(wrapper)
    return out_k, out_v.view(vals.dtype)


def sort_pairs_tile_tagged_plain(keys: torch.Tensor, tags: torch.Tensor, vals: torch.Tensor):
    """Plain version of :func:`sort_pairs_tile_tagged` (any device)."""
    _check_pairs(keys, vals, tags, "sort_pairs_tile_tagged")
    ks, vs = _pair_network(keys, _tag_bytes(tags), payload_bits(vals, "sort_pairs_tile_tagged"))
    return ks, vs.view(vals.dtype)


def sort_pairs_tile_tagged(keys: torch.Tensor, tags: torch.Tensor, vals: torch.Tensor):
    """Sort ``(key, payload)`` pairs of a ``(n,)`` or ``(rows, n)`` batch on
    the lexicographic ``(tag, key)``; the payload follows its key.

    ``tags`` are validity bits (0 = real, 1 = pad; bool or any integer
    dtype holding 0/1): a pad slot sorts after every real one, even where a
    real key equals the dtype-max pad sentinel.  ``n`` is a power-of-two
    multiple of 128.  Returns ``(keys, vals)`` sorted; one launch sorts
    every row.
    """
    if keys.device.type == "cpu":
        return sort_pairs_tile_tagged_plain(keys, tags, vals)
    _check_pairs(keys, vals, tags, "sort_pairs_tile_tagged")
    return _launch_pairs(sort_pairs_tile_tagged, keys, _tag_bytes(tags).contiguous(), vals)


sort_pairs_tile_tagged.launches = 0


def sort_pairs_tile_plain(keys: torch.Tensor, vals: torch.Tensor):
    """Plain version of :func:`sort_pairs_tile` (any device)."""
    _check_pairs(keys, vals, None, "sort_pairs_tile")
    ks, vs = _pair_network(keys, None, payload_bits(vals, "sort_pairs_tile"))
    return ks, vs.view(vals.dtype)


def sort_pairs_tile(keys: torch.Tensor, vals: torch.Tensor):
    """Sort ``(key, payload)`` pairs on the key alone (no validity tag).

    The network is not stable: equal keys may leave in any order, the
    same order as the reference's.  Shapes and dtypes as
    :func:`sort_pairs_tile_tagged`.
    """
    if keys.device.type == "cpu":
        return sort_pairs_tile_plain(keys, vals)
    _check_pairs(keys, vals, None, "sort_pairs_tile")
    return _launch_pairs(sort_pairs_tile, keys, None, vals)


sort_pairs_tile.launches = 0
