"""Batched serving engine: prefill + greedy decode over the port's models.

The port's copy of ``repro.serve.engine``.  Batch formation uses the
paper's technique: requests are sorted by prompt length with the port's
``SortEngine.sort_pairs``, which runs the tagged pair-sort kernel K5 on
the engine's device, so each left-padded prefill batch wastes the fewest
pad tokens.  Equal lengths keep their arrival order: the sort key carries
the request's index, so the order is ``np.argsort(lens, kind="stable")``
(the reference sorts the bare lengths, and its bitonic network may swap
equal ones).

``generate`` runs eagerly under ``torch.inference_mode()`` (over a mesh
``torch.no_grad()``: DTensor's view ops raise on inference tensors); the model's
``prefill`` and ``decode_step`` launch the count/rank kernel K1 once an
MoE layer.  An ``encdec`` model is prefilled against zero encoder frames
(the stub frontend's), as in the reference; a ``vlm`` model serves text
alone.

Over a mesh (``rules`` enabled, the engine made under ``common.set_mesh``
on every rank of a ``DeviceMesh``), the engine lays the parameters out
once by ``param_specs`` and each new cache by ``cache_specs``
(``launch.sharding.serve_layout``; prefill lays out the tokens and the
zero encoder frames by the batch rows), and every rank runs ``generate`` on
its own card (SPMD): the same batch order (K5 on each rank), the
vocab-gathered logits, so the same tokens on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import partition
from repro_torch.core.engine import SortEngine, _resolve_device
from repro_torch.launch.sharding import cache_specs, param_layout, sanitize_specs
from repro_torch.models.common import NO_SHARD, AxisRules, lay_out, mesh_for, set_mesh
from repro_torch.runtime.ranks import mesh_device


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray  # (len,) int32 token ids
    max_new_tokens: int = 16


class ServeEngine:
    """Serve ``requests`` with ``model_api`` (``registry.get_model_api``'s
    module: ``repro_torch.models.lm`` or ``encdec``) over ``params`` on
    ``device`` (``None``: the card, raising when there
    is none; ``"cpu"``: the CPU).  ``sorter`` orders the batch; by default
    a ``SortEngine`` on the same device.  With ``rules`` enabled under an
    ambient mesh, the engine serves over that mesh on this rank's device
    (``device``, if given, must be it)."""

    def __init__(self, cfg: ModelConfig, params, model_api, *, rules: AxisRules = NO_SHARD, max_len: int = 512,
                 sorter: SortEngine | None = None, device=None):
        self.cfg, self.api, self.rules = cfg, model_api, rules
        self.max_len = max_len
        self.mesh = mesh_for(rules)
        if self.mesh is None:
            self.device = _resolve_device(device)
        else:
            self.device = mesh_device(self.mesh)
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"this rank serves on {self.device}, not {device}")
            params = lay_out(params, param_layout(cfg, rules, self.mesh, params), self.mesh)
        self.params = params
        self.sorter = sorter if sorter is not None else SortEngine(device=self.device)
        if self.sorter.device != self.device:
            raise ValueError(f"sorter runs on {self.sorter.device}, the engine on {self.device}")
        self._prefill = lambda p, b, c: model_api.prefill(p, b, cfg, rules, c)
        self._decode = lambda p, t, c, pos: model_api.decode_step(p, t, cfg, rules, c, pos)

    def _new_cache(self, batch: int):
        """A zero cache for ``batch`` sequences of ``max_len``; over a mesh,
        laid out by ``cache_specs`` (each rank keeps its shard)."""
        cache = self.api.init_cache(self.cfg, batch, self.max_len, device=self.device)
        if self.mesh is None:
            return cache
        cspecs = sanitize_specs(cache_specs(self.cfg, self.rules, cache), cache, self.mesh)
        return lay_out(cache, cspecs, self.mesh)

    # ------------------------------------------------------- batch formation
    def order_by_length(self, requests: list[Request]) -> list[Request]:
        """Sort requests by prompt length, ties in arrival order: one pair
        sort on the engine's device (key ``len·n + index``, payload the
        index) and one transfer of the permutation back to the host."""
        n = len(requests)
        if n <= 1:
            return list(requests)
        idx = np.arange(n, dtype=np.int64)
        keys = np.asarray([len(r.prompt) for r in requests], np.int64) * n + idx
        _, order = self.sorter.sort_pairs(keys, idx.astype(np.int32))
        return [requests[i] for i in order.tolist()]

    def _pad_batch(self, requests: list[Request]):
        lens = [len(r.prompt) for r in requests]
        L = max(lens)
        # left-pad → aligned ends (right-aligned content): one vectorized
        # pack instead of a per-request copy loop
        toks = partition.pack_segments(
            np.concatenate([r.prompt for r in requests]), lens, L, fill_value=0, align="right",
        ).astype(np.int64)
        return torch.from_numpy(toks).to(self.device), L

    # --------------------------------------------------------------- serving
    def generate(self, requests: list[Request], greedy: bool = True) -> dict[int, list[int]]:
        """Greedy tokens for every request, ``max_new_tokens`` each, keyed by id."""
        if not requests:
            return {}
        # over a mesh under no_grad: DTensor's views raise in inference mode
        with (torch.inference_mode() if self.mesh is None else torch.no_grad()), (
                set_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext()):
            requests = self.order_by_length(requests)
            toks, L = self._pad_batch(requests)
            B, cfg = toks.shape[0], self.cfg
            batch = {"tokens": toks}
            if cfg.family == "encdec":
                batch["enc_frames"] = torch.zeros(
                    (B, cfg.encoder_seq_len, cfg.d_model), dtype=cfg.dtype, device=self.device
                )
            cache = self._new_cache(B)
            logits, cache = self._prefill(self.params, batch, cache)
            out = {r.id: [] for r in requests}
            steps = max(r.max_new_tokens for r in requests)
            tok = torch.argmax(logits, -1)[:, None]
            for s in range(steps):
                emitted = tok[:, 0].tolist()
                for i, r in enumerate(requests):
                    if s < r.max_new_tokens:
                        out[r.id].append(emitted[i])
                if s + 1 < steps:  # the last emitted token needs no decode step
                    logits, cache = self._decode(self.params, tok, cache, L + s)
                    tok = torch.argmax(logits, -1)[:, None]
        return out
