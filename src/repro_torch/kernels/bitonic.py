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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

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
        sort_tile.launches += 1
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
        merge_tile_pairs.launches += 1
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
