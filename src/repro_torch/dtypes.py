"""The dtype boundary between callers' numpy keys and the port's tensors.

PyTorch has barely any unsigned arithmetic: on the CPU ``minimum``, ``>``,
``+``, ``//``, ``searchsorted`` and ``scatter`` all raise for ``uint32``,
and the CUDA kernels are built for signed types only.  So unsigned keys
cross into the port through one order-preserving map, applied on entry
and undone on exit:

    u  ->  (u XOR 2**(w-1)) viewed as the signed type of the same width w

It subtracts ``2**(w-1)`` from every key, so ``a < b`` holds after the map
exactly when it held before, differences between keys are unchanged, and
the unsigned max maps onto the signed max — the dtype-max pad sentinel
survives the round trip.  Signed integers and ``float32`` pass through.
"""

from __future__ import annotations

import numpy as np
import torch

_SIGNED_TWIN = {
    np.dtype(np.uint8): np.dtype(np.int8),
    np.dtype(np.uint16): np.dtype(np.int16),
    np.dtype(np.uint32): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.int64),
}

_TORCH_UNSIGNED = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
}


def key_dtype(dtype) -> np.dtype:
    """The numpy dtype the port computes in for caller keys of ``dtype``."""
    dt = np.dtype(dtype)
    return _SIGNED_TWIN.get(dt, dt)


def key_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of :func:`key_dtype`."""
    return torch.from_numpy(np.empty(0, key_dtype(dtype))).dtype


def _flip(signed: np.dtype):
    return signed.type(np.iinfo(signed).min)


def to_keys(x: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """Map caller keys onto the port's key dtype (order-preserving).

    With ``out`` (an array of the key dtype and ``x``'s size), the keys are
    written into it and ``out`` is returned: one pass, no other array.
    """
    x = np.asarray(x)
    signed = _SIGNED_TWIN.get(x.dtype)
    if out is not None:
        if signed is None:
            np.copyto(out, x)
        else:
            np.bitwise_xor(x.view(signed), _flip(signed), out=out)
        return out
    if signed is None:
        return x
    return x.view(signed) ^ _flip(signed)


def from_keys(y: np.ndarray, dtype, inplace: bool = False) -> np.ndarray:
    """Undo :func:`to_keys`: port keys back to the caller's ``dtype``;
    with ``inplace``, over ``y``'s own memory (the result is a view of it)."""
    dt = np.dtype(dtype)
    y = np.asarray(y)
    signed = _SIGNED_TWIN.get(dt)
    if signed is None:
        return y
    if inplace:
        return np.bitwise_xor(y, _flip(signed), out=y).view(dt)
    return (y ^ _flip(signed)).view(dt)


def to_device(x: np.ndarray, device) -> torch.Tensor:
    """Caller keys (numpy) → port key tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(to_keys(x))).to(device)


def to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    """Port key tensor → numpy array of the caller's ``dtype``."""
    return from_keys(t.detach().cpu().numpy(), dtype)


def to_user_tensor(t: torch.Tensor, dtype) -> torch.Tensor:
    """Port key tensor → tensor holding the caller's ``dtype`` (same device).

    Unsigned keys come back as a bit view (``torch.uint32`` …), which
    PyTorch can hold and move but barely compute on.
    """
    dt = np.dtype(dtype)
    signed = _SIGNED_TWIN.get(dt)
    if signed is None:
        return t
    return (t ^ int(np.iinfo(signed).min)).view(_TORCH_UNSIGNED[dt])


def max_sentinel(dtype: torch.dtype):
    """Dtype-max pad fill (sorts to the end) as a Python scalar."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def min_sentinel(dtype: torch.dtype):
    """Dtype-min fill (masked out of max computations) as a Python scalar."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min
