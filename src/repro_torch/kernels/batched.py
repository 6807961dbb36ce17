"""Fused segmented row sort: the CUDA kernel plus its plain torch version.

Counterpart of ``repro.kernels.batched.batched_row_sort`` (Pallas TPU),
the engine's serving primitive under ``sort_segments``: row ``i`` of the
result is ``sorted(padded[i, :seg_lens[i]])`` followed by a dtype-max
tail, whatever the pad cells held on entry.  The kernel
(``csrc/batched.cu``) sorts one row per block in shared memory.

Two compare-exchange stages, as in the reference:

* ``method="bitonic"`` — the 4-op stage (min, max, two selects);
* ``method="bitonic2op"`` — Paeth's NICE 2-op stage,
  ``mn = min(a, b); mx = a + b - mn``, exact for integers under
  wraparound.  Float keys take the 4-op stage whatever the method.

A CPU tensor runs :func:`batched_row_sort_plain`; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch import dtypes
from repro_torch.kernels import _build, bitonic

__all__ = ["batched_row_sort", "batched_row_sort_plain", "METHODS", "MAX_ROW_BYTES"]

METHODS = ("bitonic", "bitonic2op")

# One row lives in one block's shared memory: 8192 keys of 8 bytes.
MAX_ROW_BYTES = 64 * 1024


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
        batched_row_sort.launches += 1
    return out


batched_row_sort.launches = 0
