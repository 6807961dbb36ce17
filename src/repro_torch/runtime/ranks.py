"""Ranks: one process a shard, joined into a ``DeviceMesh``.

The port's counterpart of the reference's fake host devices
(``compat.make_mesh`` under ``--xla_force_host_platform_device_count``).
Where the reference runs one program over a process's XLA devices with
``shard_map``, the port runs one process a shard (SPMD): every rank calls
the same function on its own shard, and the collectives join them.

:func:`run_ranks` spawns the ranks (``torch.multiprocessing``, start method
``spawn``), joins them through a ``file://`` store in a fresh temporary
directory (never a fixed port: concurrent launches would collide), builds
the ``DeviceMesh`` and returns each rank's result in rank order.  A rank
that raises fails the launch with its traceback.  Each rank runs on one
CPU thread.  The backend is the caller's choice and nothing picks it:

* ``gloo`` on the CPU;
* ``nccl`` for one rank a card;
* ``gloo`` when several ranks share one card (NCCL refuses two ranks on
  one device).

Shard *i* is the rank at flat position *i* in row-major mesh order, the
order of jax's flattened mesh axes, so shard layouts compare with ``==``.

The collective calls below (:func:`all_to_all`, :func:`all_gather`,
:func:`all_reduce`, :func:`reduce_scatter`, :func:`exchange`) are the ones
the dist path and ``runtime`` use, in one place so that a caller can count
or clock them.  Under gloo, the point-to-point messages of CUDA tensors
(:func:`exchange`) go through host buffers explicitly: gloo carries the
collectives of CUDA tensors but not their ``send``/``recv``.  DTensor's
gathers of CUDA tensors under gloo go through :func:`all_gather` too
(:func:`_route_gloo_cuda_gathers`): its functional all-gather crashes the
rank there (SIGSEGV in ``wait_tensor``, H100, torch 2.11), where the
functional all-reduce, reduce-scatter and all-to-all run.  The rules are
fixed here, before any run; no failure moves a collective elsewhere.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")

TIMEOUT_S = 600.0

# torch 2.13 renamed the one-tensor all-gather and reduce-scatter; older
# releases have only the old names
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# ----------------------------------------------------------------- launcher
def run_ranks(
    fn: Callable,
    mesh_shape: Sequence[int],
    mesh_dim_names: Sequence[str],
    *,
    backend: str,
    device: str = "cuda",
    args: tuple = (),
) -> list:
    """Run ``fn(mesh, *args)`` on ``prod(mesh_shape)`` spawned ranks.

    ``fn`` must be importable by name (a module-level function), as must
    every argument.  ``device`` is ``"cuda"`` (rank *r* uses card
    ``r % device_count``, and every kernel is built here first so that the
    ranks do not race ``nvcc`` into one build directory) or ``"cpu"``.
    Returns the ranks' results in rank order.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    device_type = _device_type(device)
    world = math.prod(mesh_shape)
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("nccl runs on CUDA devices: pass device='cuda' or backend='gloo'")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"nccl takes one rank a card: {world} ranks, {torch.cuda.device_count()} cards; "
                "ranks that share a card need backend='gloo'"
            )
    if device_type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        # the call goes through a file: spawn writes a child's arguments
        # into its pipe before the child reads it, one child after another
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        mp.start_processes(
            _rank_main,
            args=(world, backend, device_type, tuple(mesh_shape), tuple(mesh_dim_names), tmp),
            nprocs=world,
            join=True,
            start_method="spawn",
        )
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _rank_main(rank, world, backend, device_type, mesh_shape, names, tmp):
    import faulthandler

    faulthandler.enable()  # a rank that crashes in native code prints its Python stack
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        if backend == "gloo":
            _route_gloo_cuda_gathers()
    dist.init_process_group(
        backend,
        init_method=f"file://{os.path.join(tmp, 'store')}",
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        out = fn(make_mesh(mesh_shape, names, device_type), *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".part", path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _route_gloo_cuda_gathers() -> None:
    """Make DTensor gather a CUDA tensor under gloo with c10d's
    ``all_gather_into_tensor`` (:func:`all_gather`), which gloo carries,
    in place of the functional all-gather, which crashes the rank there.
    Both names the functional module has used are routed; other groups,
    backends and devices keep the functional call."""
    from torch.distributed import _functional_collectives as funcol

    for name in ("all_gather_tensor", "all_gather_single"):
        original = getattr(funcol, name, None)
        if original is not None:
            setattr(funcol, name, _gloo_cuda_gather(original))


def _gloo_cuda_gather(original):
    """The functional all-gather ``original`` with DTensor's gathers of a
    CUDA tensor under gloo (``group`` a (mesh, mesh dim) pair) routed
    through :func:`gather_along`."""

    def gather(self, gather_dim, group, tag=""):
        pg = group[0].get_group(group[1]) if isinstance(group, tuple) and len(group) == 2 else None
        if pg is None or not _routed(self, pg):
            return original(self, gather_dim, group, tag)
        return gather_along(self, gather_dim, pg)

    return gather


def _routed(x: torch.Tensor, pg) -> bool:
    return x.is_cuda and dist.get_backend(pg) == "gloo"


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x``s concatenated along ``dim`` in rank order, through
    :func:`all_gather` (dim 0) and a concatenation of its blocks."""
    n = dist.get_world_size(group)
    out = all_gather(x.new_empty((n * x.shape[0], *x.shape[1:])), x, group)
    return out if dim == 0 else torch.cat(out.chunk(n, dim=0), dim=dim)


# -------------------------------------------------------------------- meshes
def _device_type(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ranks run on a CUDA device and none is available; "
            "pass device='cpu' (with backend='gloo') to run them on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ranks run on cuda or cpu, not {dev}")
    return dev.type


def make_mesh(shape: Sequence[int], names: Sequence[str], device_type: str = "cuda", ranks=None):
    """A ``DeviceMesh`` of ``shape`` over ``ranks`` (default the first
    ``prod(shape)`` ranks), row-major, on ``device_type`` (``"cuda"`` or
    ``"cpu"``).  Every rank of the world calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    ranks = list(range(n)) if ranks is None else list(ranks)[:n]
    return DeviceMesh(_device_type(device_type), torch.tensor(ranks).view(tuple(shape)),
                      mesh_dim_names=tuple(names))


def mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the CPU, or the current card."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh, names: Sequence[str]):
    """The process group of the mesh dims ``names`` taken as one flattened
    axis, row-major in mesh order (the reference's multi-axis collectives)."""
    names = tuple(names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    dims = [mesh.mesh_dim_names.index(a) for a in names]
    if dims != sorted(dims):
        raise ValueError(f"axes {names} must be in mesh order {mesh.mesh_dim_names}")
    if names == tuple(mesh.mesh_dim_names) and mesh.mesh.flatten().tolist() == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return mesh[names]._flatten().get_group()


def shard_index(mesh, names: Sequence[str]) -> int:
    """This rank's position along the flattened axes ``names``."""
    sizes = mesh_sizes(mesh)
    idx = 0
    for a in names:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


# --------------------------------------------------------------- collectives
def all_to_all(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all of the leading dim: block *d* of ``inp`` goes
    to group rank *d*; ``out`` holds the blocks in source order."""
    dist.all_to_all_single(out, inp.contiguous(), group=group)
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """``out`` = the group's ``inp``s concatenated along dim 0, in rank order."""
    _ALL_GATHER(out, inp.contiguous(), group=group)
    return out


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``op`` (a ``dist.ReduceOp``) over the group, in place."""
    dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, rank *d* keeping block *d* of dim 0."""
    _REDUCE_SCATTER(out, inp.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def exchange(send: "torch.Tensor | None", to: "int | None", recv: "torch.Tensor | None", frm: "int | None"):
    """Send ``send`` to global rank ``to`` and receive into ``recv`` from
    global rank ``frm`` (either may be ``None``), posted together so that
    neighbours cannot deadlock.  Under gloo, CUDA tensors go through host
    buffers: gloo's TCP transport would write from the device pointer, and
    a CUDA ``send`` aborts the rank ("writev ... Bad address", H100, torch
    2.11)."""
    staged = dist.get_backend() == "gloo"
    ops = []
    host_recv = None
    if send is not None:
        buf = send.cpu() if staged and send.is_cuda else send.contiguous()
        ops.append(dist.P2POp(dist.isend, buf, to))
    if recv is not None:
        if staged and recv.is_cuda:
            host_recv = torch.empty_like(recv, device="cpu")
        ops.append(dist.P2POp(dist.irecv, recv if host_recv is None else host_recv, frm))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if host_recv is not None:
        recv.copy_(host_recv)
    return recv
