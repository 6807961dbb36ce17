"""Fused segmented row sort: the CUDA kernel plus its plain torch version.

Counterpart of ``repro.kernels.batched.batched_row_sort`` (Pallas TPU),
the engine's serving primitive under ``sort_segments``: row ``i`` of the
result is ``sorted(padded[i, :seg_lens[i]])`` followed by a dtype-max
tail, whatever the pad cells held on entry.  The kernel
(``csrc/batched.cu``) runs the tile sort's tiers with the refill made on
load: an int32 or float32 row of up to 8,192 keys is one block's chunk and
one launch; a longer row takes the tile sort's later launches.

Two compare-exchange stages, as in the reference:

* ``method="bitonic"`` — the 4-op stage (min, max, two selects);
* ``method="bitonic2op"`` — Paeth's NICE 2-op stage,
  ``mn = min(a, b); mx = a + b - mn``, exact for integers under
  wraparound.  Float keys take the 4-op stage whatever the method.

A CPU tensor runs :func:`batched_row_sort_plain`; a CUDA tensor launches
the kernel or raises.

:func:`batched_row_sort_pairs` is the ``(key, payload)`` twin
(``repro.kernels.batched.batched_row_sort_pairs``): validity rides as the
tag of the lexicographic ``(tag, key)`` exchange, computed in the kernel
from the row length, so real keys equal to the dtype max keep their
payloads ahead of the pad tail (sentinel keys, zero payloads).  A row
whose keys, payloads and tags fit one block's shared memory
(``MAX_PAIR_ROW_BYTES``) is sorted by one block of ``csrc/batched.cu``;
a longer row gets its fill from torch ops and is sorted by the
multi-pass pair kernel of ``csrc/bitonic.cu``
(:func:`bitonic.sort_pairs_tile_tagged`).
"""

from __future__ import annotations

import torch

from repro_torch import dtypes
from repro_torch.kernels import _build, _launches, bitonic

__all__ = [
    "batched_row_sort",
    "batched_row_sort_plain",
    "batched_row_sort_pairs",
    "batched_row_sort_pairs_plain",
    "METHODS",
    "MAX_ROW_BYTES",
    "MAX_PAIR_ROW_BYTES",
]

METHODS = ("bitonic", "bitonic2op")

# The longest row the reference's callers hand it: 8192 keys of 8 bytes.
MAX_ROW_BYTES = 64 * 1024
# A pair row's keys, payloads and one tag byte a pair, against the 227 KB
# of shared memory a block may opt into on Hopper.
MAX_PAIR_ROW_BYTES = 232_448


def _validate(padded: torch.Tensor, seg_lens: torch.Tensor, method: str) -> int:
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    bitonic.check_keys(padded, "batched_row_sort")
    if padded.dim() != 2:
        raise ValueError(f"batched_row_sort takes (B, L), got {tuple(padded.shape)}")
    rows, length = padded.shape
    log_n = bitonic.check_tile(length)
    if length * padded.element_size() > MAX_ROW_BYTES:
        raise ValueError(
            f"row of {length} x {padded.element_size()} bytes exceeds {MAX_ROW_BYTES}"
        )
    if seg_lens.shape != (rows,) or seg_lens.dtype != torch.int32:
        raise ValueError(f"seg_lens must be ({rows},) int32, got {tuple(seg_lens.shape)} {seg_lens.dtype}")
    if seg_lens.device != padded.device:
        raise ValueError("seg_lens and padded lie on different devices")
    return log_n


def _two_op(method: str, dtype: torch.dtype) -> bool:
    return method == "bitonic2op" and not dtype.is_floating_point


def batched_row_sort_plain(
    padded: torch.Tensor, seg_lens: torch.Tensor, *, method: str = "bitonic"
) -> torch.Tensor:
    """Plain version of :func:`batched_row_sort` (any device)."""
    _validate(padded, seg_lens, method)
    pos = torch.arange(padded.shape[1], device=padded.device)
    fill = torch.tensor(dtypes.max_sentinel(padded.dtype), dtype=padded.dtype, device=padded.device)
    x = torch.where(pos[None, :] < seg_lens[:, None], padded, fill)
    return bitonic._sort_network(x, two_op=_two_op(method, padded.dtype))


def batched_row_sort(
    padded: torch.Tensor, seg_lens: torch.Tensor, *, method: str = "bitonic"
) -> torch.Tensor:
    """Sort every row of ``padded (B, L)`` to its ``seg_lens`` valid length.

    ``L`` is a power-of-two multiple of 128 and one row fits
    ``MAX_ROW_BYTES``; ``seg_lens`` is ``(B,)`` int32 on the same device.
    """
    log_n = _validate(padded, seg_lens, method)
    if padded.device.type == "cpu":
        return batched_row_sort_plain(padded, seg_lens, method=method)
    if not seg_lens.is_contiguous():
        raise ValueError("batched_row_sort: seg_lens must be contiguous")
    out = torch.empty_like(padded)
    rows = padded.shape[0]
    if rows:
        lib = _build.load("batched")
        code = lib.rt_batched_row_sort(
            bitonic.DTYPE_CODES[padded.dtype],
            int(_two_op(method, padded.dtype)),
            padded.data_ptr(),
            out.data_ptr(),
            seg_lens.data_ptr(),
            rows,
            log_n,
            bitonic.stream_handle(),
        )
        _build.check(lib, code, "batched_row_sort")
        _launches.count(batched_row_sort)
    return out


batched_row_sort.launches = 0


# ------------------------------------------------------------- pair rows
def _validate_pairs(keys: torch.Tensor, vals: torch.Tensor, seg_lens: torch.Tensor) -> int:
    bitonic.check_keys(keys, "batched_row_sort_pairs")
    if keys.dim() != 2:
        raise ValueError(f"batched_row_sort_pairs takes (B, L), got {tuple(keys.shape)}")
    if vals.shape != keys.shape or vals.device != keys.device:
        raise ValueError("batched_row_sort_pairs: vals differ from keys in shape or device")
    rows = keys.shape[0]
    if seg_lens.shape != (rows,) or seg_lens.dtype != torch.int32:
        raise ValueError(f"seg_lens must be ({rows},) int32, got {tuple(seg_lens.shape)} {seg_lens.dtype}")
    if seg_lens.device != keys.device:
        raise ValueError("seg_lens and keys lie on different devices")
    return bitonic.check_tile(keys.shape[1])


def _fill_pairs(keys, vbits, seg_lens):
    """Sentinel keys, 1 tags and zero payloads at and past each row's length."""
    pos = torch.arange(keys.shape[1], device=keys.device)
    valid = pos[None, :] < seg_lens[:, None]
    fill = torch.tensor(dtypes.max_sentinel(keys.dtype), dtype=keys.dtype, device=keys.device)
    k = torch.where(valid, keys, fill)
    v = torch.where(valid, vbits, torch.zeros((), dtype=vbits.dtype, device=vbits.device))
    return k, (~valid).to(torch.uint8), v


def batched_row_sort_pairs_plain(keys: torch.Tensor, vals: torch.Tensor, seg_lens: torch.Tensor):
    """Plain version of :func:`batched_row_sort_pairs` (any device)."""
    _validate_pairs(keys, vals, seg_lens)
    k, t, v = _fill_pairs(keys, bitonic.payload_bits(vals, "batched_row_sort_pairs"), seg_lens)
    ks, vs = bitonic._pair_network(k, t, v)
    return ks, vs.view(vals.dtype)


def batched_row_sort_pairs(keys: torch.Tensor, vals: torch.Tensor, seg_lens: torch.Tensor):
    """Sort the ``(key, payload)`` pairs of every row of ``(B, L)`` to its
    ``seg_lens`` valid length.

    Row ``i`` comes out as its first ``seg_lens[i]`` pairs sorted by key
    (payloads with their keys), then dtype-max keys with zero payloads,
    whatever the pad cells held.  ``L`` is a power-of-two multiple of 128;
    ``seg_lens`` is ``(B,)`` int32 on the same device.  The payload may be
    of any dtype 1, 2, 4 or 8 bytes wide.
    """
    if keys.device.type == "cpu":
        return batched_row_sort_pairs_plain(keys, vals, seg_lens)
    log_n = _validate_pairs(keys, vals, seg_lens)
    vbits = bitonic.payload_bits(vals, "batched_row_sort_pairs")
    rows, length = keys.shape
    if length * (keys.element_size() + vals.element_size() + 1) > MAX_PAIR_ROW_BYTES:
        # Past one block's shared memory: the same fill in torch, then the
        # multi-pass pair kernel over the rows.
        k, t, v = _fill_pairs(keys, vbits, seg_lens)
        ks, vs = bitonic.sort_pairs_tile_tagged(k, t, v)
        return ks, vs.view(vals.dtype)
    for x in (keys, vals, seg_lens):
        if not x.is_contiguous():
            raise ValueError("batched_row_sort_pairs: the kernel takes contiguous tensors only")
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vbits)
    if rows:
        lib = _build.load("batched")
        code = lib.rt_batched_row_sort_pairs(
            bitonic.DTYPE_CODES[keys.dtype],
            vbits.element_size(),
            keys.data_ptr(),
            vbits.data_ptr(),
            out_k.data_ptr(),
            out_v.data_ptr(),
            seg_lens.data_ptr(),
            rows,
            log_n,
            bitonic.stream_handle(),
        )
        _build.check(lib, code, "batched_row_sort_pairs")
        _launches.count(batched_row_sort_pairs)
    return out_k, out_v.view(vals.dtype)


batched_row_sort_pairs.launches = 0
