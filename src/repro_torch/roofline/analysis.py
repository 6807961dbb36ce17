"""Three-term roofline from a traced dry-run step.

The port's copy of ``repro.roofline.analysis``:

    compute    = FLOPs             / peak_FLOP/s
    memory     = bytes             / HBM_bw
    collective = collective bytes  / link_bw   (per link class)

and the bound is the largest of the three.  ``np_prod``, ``bound_time_s``
and ``model_flops_for`` are the reference's arithmetic, line for line.

The reference reads FLOPs and bytes from a compiled artifact's
``cost_analysis()`` and collectives from its post-SPMD HLO text
(``COLLECTIVE_RE``, ``SHAPE_RE``, ``_line_bytes``).  torch has neither, so
the port traces one device's share of a step on fake tensors instead
(``trace``): FLOPs from ``FlopCounterMode``, bytes as XLA's "bytes
accessed" (every non-view aten op's operands and results), and the peak
of the bytes the step allocated.  The HLO parsers have no input here; the
dry-run derives each collective from the sanitized spec trees and the
per-device view (``Collective`` records), and ``collective_bytes`` sums
them into the reference's dict.  A collective is inter-pod when its axes
include ``pod``: the axis-level counterpart of the reference's device-id
test.  A kernel wrapper on the path (K1's ``repro_torch::bucket_count_rank``)
is one op with 0 FLOPs, as XLA counts a custom call.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.roofline.hw import HW, V5E

# The reference's collective kinds, in its HLO names.
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# Ops that move no byte: allocations without a write, and a reshape that
# aliases its input without being marked a view.
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format,
    torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default,
    torch.ops.aten.new_empty.default,
    torch.ops.aten._unsafe_view.default,
}
# Namespaces of ops that touch memory; ``prim`` holds metadata queries
# (``prim.device`` and the like).
_COUNTED_NAMESPACES = ("aten", "repro_torch")


def np_prod(shp):
    n = 1
    for d in shp:
        n *= d
    return n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ------------------------------------------------------------------- trace
@dataclasses.dataclass(frozen=True)
class Collective:
    """``count`` collectives of one ``kind`` over mesh ``axes``, each
    writing ``nbytes`` a device (the reference counts an op's output
    shape); ``what`` names the tensor."""

    kind: str
    axes: tuple[str, ...]
    nbytes: int
    count: int = 1
    what: str = ""


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One non-view op of a trace: its result bytes, name and shapes."""

    out_bytes: int
    op: str
    shapes: str


class _OpCounter(TorchDispatchMode):
    """Bytes accessed by every non-view op; the bytes of the storages the
    traced step makes, live and at their peak (a storage's bytes leave the
    count when the step drops its last reference)."""

    def __init__(self, inputs, keep_ops: bool):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops: list[OpRecord] | None = [] if keep_ops else None
        self._made = WeakIdKeyDictionary()
        self._inputs = WeakIdKeyDictionary()
        for t in inputs:
            self._inputs[t.untyped_storage()] = True

    def made(self, t: torch.Tensor) -> bool:
        return t.untyped_storage() in self._made

    def is_input(self, t: torch.Tensor) -> bool:
        return t.untyped_storage() in self._inputs

    def _free(self, nbytes: int, _ref) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _NO_TRAFFIC or func.namespace not in _COUNTED_NAMESPACES:
            return out
        results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        read = sum(_nbytes(t) for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor))
        written = sum(_nbytes(t) for t in results)
        self.bytes += read + written
        for t in results:
            st = t.untyped_storage()
            if st in self._made or st in self._inputs:
                continue
            nbytes = st.nbytes()
            self._made[st] = weakref.ref(st, lambda ref, n=nbytes: self._free(n, ref))
            self.live += nbytes
        self.peak = max(self.peak, self.live)
        if self.ops is not None:
            shapes = " ".join(f"{str(t.dtype)[6:]}{list(t.shape)}" for t in results)
            self.ops.append(OpRecord(written, str(func), shapes))
        return out


@dataclasses.dataclass
class Trace:
    """One traced step: per-device FLOPs and bytes accessed, the peak of
    the bytes it allocated (``peak_bytes``), the bytes of its results, of
    the results it allocated (``made_out_bytes``) and of the results that
    are its inputs updated in place (``alias_bytes``: the port's buffer
    donation), and each op when asked for."""

    flops: float
    bytes: float
    peak_bytes: int
    out_bytes: int
    made_out_bytes: int
    alias_bytes: int
    ops: list[OpRecord] | None


def trace(fn, args, *, keep_ops: bool = False) -> Trace:
    """Run ``fn(*args)`` once under the counters.  ``args`` are fake tensors
    (or trees of them) made inside the caller's ``FakeTensorMode``, which
    must be active; nothing is computed and nothing launches."""
    inputs = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    flops = FlopCounterMode(display=False)
    counter = _OpCounter(inputs, keep_ops)
    with flops, counter:
        out = fn(*args)
    results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    made, alias, seen = 0, 0, set()
    for t in results:
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        if counter.made(t):
            made += st.nbytes()
        elif counter.is_input(t):
            alias += st.nbytes()
    return Trace(
        flops=float(flops.get_total_flops()),
        bytes=float(counter.bytes),
        peak_bytes=counter.peak,
        out_bytes=sum(_nbytes(t) for t in results),
        made_out_bytes=made,
        alias_bytes=alias,
        ops=counter.ops,
    )


def memory_analysis(tr: Trace, *, argument_bytes: int, gathered_gradient_bytes: int = 0) -> dict:
    """The reference's ``memory_analysis`` record for a traced step.

    ``temp_bytes`` is the trace's peak less the results it made (XLA keeps
    results out of temp) and less ``gathered_gradient_bytes``: a traced
    train step holds every gathered parameter's gradient at its gathered
    width to the end of its backward, where a sharded step keeps its
    shard.
    ``alias_bytes`` are the results that are inputs updated in place;
    ``total_bytes`` is the reference's sum."""
    temp = max(0, tr.peak_bytes - tr.made_out_bytes - gathered_gradient_bytes)
    return {
        "argument_bytes": argument_bytes,
        "output_bytes": tr.out_bytes,
        "temp_bytes": temp,
        "alias_bytes": tr.alias_bytes,
        "total_bytes": argument_bytes + tr.out_bytes + temp - tr.alias_bytes,
        "gathered_gradient_bytes": gathered_gradient_bytes,
    }


def collective_bytes(collectives) -> dict:
    """Sum ``Collective`` records (per device) into the reference's dict:
    total / intra-pod / inter-pod bytes, per-kind totals, the op count and
    ``halved`` (always 0: a trace keeps each tensor's own dtype, so there
    is no CPU upcast to correct)."""
    out = {"total": 0, "intra_pod": 0, "inter_pod": 0, "by_kind": {}, "count": 0, "halved": 0}
    for c in collectives:
        if c.kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {c.kind!r}")
        b = c.nbytes * c.count
        out["total"] += b
        out["count"] += c.count
        out["by_kind"][c.kind] = out["by_kind"].get(c.kind, 0) + b
        out["inter_pod" if "pod" in c.axes else "intra_pod"] += b
    return out


def param_shape_set(params_shape_tree) -> set:
    """Full + transposed 2-D(+) parameter shapes, over a tree (dicts,
    tuples, lists) of tensors or shape tuples; the reference's CPU-upcast
    set, kept for its API (a trace needs no halving)."""

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (tuple, list)) and not all(isinstance(d, int) for d in tree):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    out = set()
    for leaf in leaves(params_shape_tree):
        shp = tuple(int(x) for x in (leaf.shape if hasattr(leaf, "shape") else leaf))
        if len(shp) >= 2:
            out.add(shp)
            out.add(tuple(reversed(shp)))
            # layer-stacked variants appear unstacked in unrolled HLO
            if len(shp) >= 3:
                out.add(shp[1:])
                out.add(tuple(reversed(shp[1:])))
    return out


# ---------------------------------------------------------------- roofline
def bound_time_s(
    *,
    flops: float = 0.0,
    bytes_moved: float = 0.0,
    intra_pod_bytes: float = 0.0,
    inter_pod_bytes: float = 0.0,
    hw: HW = V5E,
) -> float:
    """Roofline lower bound on wall time for an abstract workload.

    The shared arithmetic behind the perf subsystem's machine
    normalisation (``repro_torch.perf.normalize``, DESIGN.md §9).
    """
    t_compute = flops / hw.peak_bf16_flops if flops else 0.0
    t_memory = bytes_moved / hw.hbm_bw if bytes_moved else 0.0
    t_coll = 0.0
    if intra_pod_bytes:
        t_coll += intra_pod_bytes / hw.ici_bw
    if inter_pod_bytes:
        t_coll += inter_pod_bytes / hw.inter_pod_bw
    return max(t_compute, t_memory, t_coll)


def roofline_from_trace(
    tr: Trace,
    coll: dict,
    memory: dict,
    *,
    num_devices: int,
    hw: HW = V5E,
    model_flops: float | None = None,
) -> dict:
    """The §Roofline record for one (arch × shape × mesh) cell: the
    reference's ``roofline_from_compiled`` record, key for key, from a
    trace, its ``collective_bytes`` and its ``memory_analysis``."""
    t_compute = tr.flops / hw.peak_bf16_flops
    t_memory = tr.bytes / hw.hbm_bw
    t_coll = coll["intra_pod"] / hw.ici_bw + coll["inter_pod"] / hw.inter_pod_bw
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    rec = {
        "flops_per_device": tr.flops,
        "bytes_per_device": tr.bytes,
        "collective_bytes": coll,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": max(terms, key=terms.get),
        "bound_time_s": max(terms.values()),
        "memory_analysis": dict(memory),
    }
    if model_flops is not None:
        total_flops = tr.flops * num_devices
        rec["model_flops"] = model_flops
        rec["useful_flops_ratio"] = model_flops / total_flops if total_flops else 0.0
        rec["mfu_bound"] = (
            (model_flops / num_devices / hw.peak_bf16_flops) / rec["bound_time_s"] if rec["bound_time_s"] > 0 else 0.0
        )
    return rec


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train; 2·N·D_active per generated token batch for
    decode; 2·N·D for prefill.  MoE uses active params."""
    n = cfg.param_count()
    if cfg.is_moe:
        m = cfg.moe
        total_e = 3 * cfg.d_model * m.expert_d_ff * m.num_experts
        active_e = 3 * cfg.d_model * m.expert_d_ff * m.num_experts_per_tok
        n = n - cfg.num_layers * (total_e - active_e)
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d_tokens
