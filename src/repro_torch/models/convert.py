"""Parameters from numpy: the bridge from the JAX package's pytrees.

``params_from_numpy`` turns a tree of numpy arrays (dicts, lists and
tuples, as ``jax.tree.map(np.asarray, params)`` gives them) into the
port's tensors with the same structure, so both packages can compute on
the same weights.  The port's parameter layout is the reference's, leaf
for leaf, so this is a plain tree map.  ``state_from_numpy`` carries a
whole train state across the same way (parameters, AdamW's ``m``, ``v``,
``count`` and ``master``, the step, the int8 error feedback), so both
packages' trainers can start from one state.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One array as a tensor on ``device``, its dtype kept.

    ``bfloat16`` arrays (``ml_dtypes``) cross as their 16 bits:
    ``torch.from_numpy`` takes no bfloat16.
    """
    a = np.array(a, order="C")  # a writable copy: the tensor owns its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device):
    """The tree with every array as a tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def state_from_numpy(tree, device):
    """The reference's train state (``jax.tree.map(np.asarray, state)``)
    as the port's: every array a tensor on ``device``, bf16 leaves kept."""
    return params_from_numpy(tree, device)
