"""Checkpointing: atomic, async: the port's copy of ``repro.ckpt.checkpointer``.

Layout:  <dir>/step_<N>/manifest.json + <leaf-path>.npy per tree leaf.
Writes go to ``step_<N>.tmp`` then ``os.rename``, so a crashed save can
never be mistaken for a complete checkpoint.  Saves can run on a
background thread (``async_save``); ``wait()`` joins before the next save
or exit.  ``save`` copies every leaf to the host before it returns, since
the train step goes on to update the tensors in place.

Leaves are stored as full arrays and restored onto ``device``.  A
bfloat16 leaf is stored as its 16 bits (``uint16``; numpy has no
bfloat16 without ``ml_dtypes``) and its dtype recorded in the manifest;
every other torch dtype maps to its numpy twin, so every leaf
round-trips bit for bit.

A DTensor leaf (a state sharded over ranks) is written as its logical
array, as the reference writes its global arrays: every rank of its mesh
calls ``save`` and gathers it (``full_tensor()``), rank 0 alone writes,
synchronously, and the ranks meet at a barrier before ``save`` returns.
``restore`` gives plain tensors, which ``repro_torch.runtime.reshard_state``
lays onto any mesh whose axes divide them.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.common import is_dtensor


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict, skeleton):
    if isinstance(skeleton, dict):
        return {k: _unflatten(
            {p[len(k) + 1 :]: v for p, v in flat.items() if p.split("/")[0] == k},
            skeleton[k],
        ) for k in skeleton}
    if isinstance(skeleton, (list, tuple)):
        vals = [
            _unflatten(
                {p[len(str(i)) + 1 :]: v for p, v in flat.items() if p.split("/")[0] == str(i)},
                s,
            )
            for i, s in enumerate(skeleton)
        ]
        return type(skeleton)(vals)
    return flat[""]


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` that later in-place updates cannot reach; a
    DTensor's whole logical array (a collective over its mesh)."""
    if is_dtensor(x):
        x = x.full_tensor()
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _from_host(a: np.ndarray, dtype: "str | None", device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: dict | None = None, async_save=False):
        self.wait()
        flat = _flatten(tree)
        dtypes = {path: "bfloat16" for path, x in flat.items() if x.dtype == torch.bfloat16}
        host = {path: _to_host(x) for path, x in flat.items()}
        if any(is_dtensor(x) for x in flat.values()):
            import torch.distributed as dist

            if dist.get_rank() == 0:
                self._write(step, host, dtypes, extra)
            dist.barrier()
            return
        if async_save:
            self._thread = threading.Thread(target=self._write, args=(step, host, dtypes, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, dtypes, extra)

    def _write(self, step: int, host: dict, dtypes: dict, extra):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}, "dtypes": dtypes, "extra": extra or {}}
        for path, arr in host.items():
            fname = path.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][path] = fname
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, skeleton, device="cpu"):
        """Load a checkpoint onto ``device``.  Returns (tree, extra)."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        flat = {
            path: _from_host(np.load(os.path.join(d, fname)), dtypes.get(path), device)
            for path, fname in manifest["leaves"].items()
        }
        return _unflatten(flat, skeleton), manifest.get("extra", {})
