"""Gradient compression for the data-parallel reduction: per-tensor int8
quantisation with error feedback.

The port's copy of ``repro.optim.compression``.  ``compress_grads`` is
the numerics model (quantise → dequantise with an error-feedback residual
carried in the train state).  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor):
    xf = x.to(torch.float32)
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_grads(grads, error_fb):
    """Quantise each gradient leaf with error feedback.

    Returns (decompressed_grads, new_error_fb).  ``error_fb`` is a tree
    like ``grads`` (float32) carrying the quantisation residual to the
    next step.
    """

    def one(g, e):
        gf = g.to(torch.float32) + e
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), gf - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error_fb))]
    return tree_unflatten(grads, [o[0] for o in out]), tree_unflatten(grads, [o[1] for o in out])


def init_error_fb(grads_or_params):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_or_params)
